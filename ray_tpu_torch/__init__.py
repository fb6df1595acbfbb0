"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

A second package beside ``ray_tpu`` (the JAX reference, which it never
imports). It holds the models (``models``), attention on hand-written
CUDA flash kernels (``ops``), the train step, optimizers, checkpoints
and the trainer (``train``), the mesh and its collectives (``parallel``,
``collective``), the single-node core runtime (``core``): tasks,
actors, the shared-memory object store and placement groups, with the
GPU as a scheduler resource, the Data library on it (``data``),
Serve (``serve``), whose replicas hold cards, Tune (``tune``), whose
trials hold cards or shares of one, and RLlib (``rllib``), whose learners
hold the card while its env runners step on the CPU, with the host
collective plane (``collective``) between learner processes, DAGs and
compiled DAGs (``dag``), whose stage actors pipeline over shared-memory
channels (``experimental.channel``), durable workflows
(``workflow``), the dashboard (``dashboard``), job submission
(``job_submission``) and the autoscaler (``autoscaler``), whose nodes
hold cards, the command line (``scripts.cli``), the core microbenchmarks
(``perf``) and C++ tasks (``cpp``, ``cpp_function``).

Entry points run on the card by default and raise when none is visible;
``device="cpu"`` runs them on the CPU with the kernels' plain versions.
Importing this package imports no torch: a runtime worker that runs no
tensor task never loads it.

Public core API (as ``ray_tpu``'s):
    ray_tpu_torch.init / shutdown
    @ray_tpu_torch.remote       -> RemoteFunction / ActorClass
    ray_tpu_torch.get / put / wait
    ray_tpu_torch.ObjectRef
    ray_tpu_torch.placement_group
"""

__version__ = "0.1.0"

from ray_tpu_torch.core.api import (  # noqa: E402
    available_resources,
    cancel,
    client_address,
    cluster_resources,
    get,
    get_actor,
    get_gpu_ids,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch.core.object_ref import (  # noqa: E402
    ObjectRef,
    ObjectRefGenerator,
)
from ray_tpu_torch.core.actor import ActorHandle  # noqa: E402
from ray_tpu_torch.core.exceptions import (  # noqa: E402
    ActorDiedError,
    ActorError,
    GetTimeoutError,
    ObjectLostError,
    RayTpuError,
    TaskError,
)
from ray_tpu_torch.core.placement_group import (  # noqa: E402
    PlacementGroup,
    PlacementGroupSchedulingStrategy,
    get_current_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.core.ids import (  # noqa: E402
    ActorClassID,
    ActorID,
    FunctionID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    UniqueID,
    WorkerID,
)
from ray_tpu_torch.core.logging_config import LoggingConfig  # noqa: E402
from ray_tpu_torch.client_builder import ClientBuilder, client  # noqa: E402
from ray_tpu_torch.cross_language import (  # noqa: E402
    Language,
    cpp_function,
    java_actor_class,
    java_function,
)

# Worker-mode constants (reference: python/ray/_private/worker.py —
# SCRIPT_MODE drivers, WORKER_MODE executors, LOCAL_MODE inline).
SCRIPT_MODE = 0
WORKER_MODE = 1
LOCAL_MODE = 2

# (reference: ray.DynamicObjectRefGenerator — the num_returns=
# "streaming"/"dynamic" return type; one class serves both here)
DynamicObjectRefGenerator = ObjectRefGenerator


def show_in_dashboard(message: str, key: str = "") -> None:
    """Publish a short free-form message for this process to the
    dashboard's KV (reference: ray.show_in_dashboard — per-worker
    display strings). Readable via
    ``experimental.internal_kv._kv_get(f"worker_msg:{pid}|{key}",
    namespace="dashboard")``."""
    import os

    from ray_tpu_torch.experimental.internal_kv import _kv_put
    _kv_put(f"worker_msg:{os.getpid()}|{key}", message.encode(),
            namespace="dashboard")


__all__ = [
    "__version__",
    "init", "shutdown", "is_initialized",
    "remote", "method",
    "get", "put", "wait", "cancel", "kill", "get_actor",
    "get_gpu_ids", "available_resources", "cluster_resources", "nodes",
    "timeline", "get_runtime_context",
    "ObjectRef", "ObjectRefGenerator", "ActorHandle",
    "RayTpuError", "TaskError", "ActorError", "ActorDiedError",
    "ObjectLostError", "GetTimeoutError",
    "PlacementGroup", "PlacementGroupSchedulingStrategy",
    "placement_group", "remove_placement_group",
    "get_current_placement_group", "placement_group_table",
    "LoggingConfig", "ClientBuilder", "client", "client_address",
    "ActorClassID", "ActorID", "FunctionID", "JobID", "NodeID",
    "ObjectID", "PlacementGroupID", "TaskID", "UniqueID", "WorkerID",
    "Language", "cpp_function", "java_actor_class", "java_function",
    "SCRIPT_MODE", "WORKER_MODE", "LOCAL_MODE",
    "DynamicObjectRefGenerator", "show_in_dashboard",
]


_SUBPACKAGES = ("data", "train", "serve", "tune", "rllib", "workflow",
                "autoscaler", "dag", "experimental", "util", "runtime_env",
                "collective", "cluster_utils", "cpp")


def __getattr__(name: str):
    """Lazy subpackage attributes, as ``ray_tpu``'s: ``import
    ray_tpu_torch`` is enough for ``ray_tpu_torch.serve.run(...)``,
    without every library's import cost up front."""
    if name in _SUBPACKAGES:
        import importlib
        mod = importlib.import_module(f"ray_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
