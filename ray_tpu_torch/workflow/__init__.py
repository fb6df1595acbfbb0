"""Durable workflows (reference: python/ray/workflow/).

Counterpart of ``ray_tpu/workflow``: steps are the port's tasks, so a
step with ``num_gpus=1`` runs on a card; step results are pickled by the
port's serializer into the workflow's storage root."""

from ray_tpu_torch.workflow.api import (
    EventListener,
    cancel,
    continuation,
    delete,
    get_metadata,
    get_output,
    get_output_async,
    get_status,
    init,
    list_all,
    options,
    resume,
    resume_all,
    resume_async,
    run,
    run_async,
    sleep,
    wait_for_event,
)
from ray_tpu_torch.workflow.common import (
    WorkflowCancellationError,
    WorkflowError,
    WorkflowExecutionError,
    WorkflowStatus,
)

__all__ = [
    "init", "run", "run_async", "resume", "resume_async", "resume_all",
    "get_output", "get_output_async", "get_status", "get_metadata",
    "list_all", "cancel", "delete", "sleep", "wait_for_event",
    "EventListener", "continuation", "options", "WorkflowStatus",
    "WorkflowError", "WorkflowExecutionError",
    "WorkflowCancellationError",
]
