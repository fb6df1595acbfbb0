"""ray_tpu_torch.serve — online serving (Ray Serve analog).

Reference shape being re-based (SURVEY.md §3.5): a singleton
ServeController actor reconciles deployments into replica actors; an
HTTP proxy actor (aiohttp) routes ingress; handles route directly to
replicas with power-of-two-choices load balancing. On the card:
replicas are ordinary actors, so a replica can hold a GPU (or a share of
one, ``ray_actor_options={"num_gpus": ...}``) and serve a model on it;
batching (@serve.batch) aggregates requests into one forward on the
card.
"""

from ray_tpu_torch.serve.asgi import ingress
from ray_tpu_torch.serve.api import (
    deploy_config,
    deployment,
    run,
    status,
    shutdown,
    get_deployment_handle,
    get_app_handle,
    start,
    delete,
    grpc_ingress_token,
    batch,
    Application,
    Deployment,
    DeploymentHandle,
    DeploymentResponse,
    HTTPOptions,
)
from ray_tpu_torch.serve.replica import get_replica_context, ReplicaContext
from ray_tpu_torch.serve.autoscaling import AutoscalingConfig
from ray_tpu_torch.serve.exceptions import (
    ServeError,
    ReplicaUnavailableError,
    ReplicaStoppingError,
    ReplicaOverloadedError,
    DeploymentOverloadedError,
    RequestRetriesExhaustedError,
    RequestDeadlineError,
    ModelLoadError,
)
from ray_tpu_torch.serve.multiplex import (
    get_multiplexed_model_id,
    multiplexed,
)

__all__ = [
    "ingress",
    "deployment", "run", "shutdown", "get_deployment_handle", "batch",
    "deploy_config", "status",
    "grpc_ingress_token",
    "Application", "Deployment", "DeploymentHandle", "DeploymentResponse",
    "AutoscalingConfig", "multiplexed", "get_multiplexed_model_id",
    "ServeError", "ReplicaUnavailableError", "ReplicaStoppingError",
    "ReplicaOverloadedError", "DeploymentOverloadedError",
    "RequestRetriesExhaustedError", "RequestDeadlineError",
    "ModelLoadError",
]
