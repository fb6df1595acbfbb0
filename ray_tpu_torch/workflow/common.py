"""Workflow shared types (reference: python/ray/workflow/common.py).

Counterpart of ``ray_tpu/workflow/common.py``."""

from __future__ import annotations


class WorkflowStatus:
    RUNNING = "RUNNING"
    SUCCESSFUL = "SUCCESSFUL"
    FAILED = "FAILED"
    RESUMABLE = "RESUMABLE"
    CANCELED = "CANCELED"
    PENDING = "PENDING"


class WorkflowError(Exception):
    """Base workflow error (reference:
    python/ray/workflow/exceptions.py)."""


class WorkflowExecutionError(WorkflowError):
    """Raised when reading a FAILED workflow's durable output
    (get_output from another process / get_output_async); an
    in-process run()/get_output re-raises the causing step exception
    directly (reference: WorkflowExecutionError)."""


class WorkflowCancellationError(WorkflowError):
    """Raised when reading the output of a canceled workflow
    (reference: WorkflowCancellationError)."""
