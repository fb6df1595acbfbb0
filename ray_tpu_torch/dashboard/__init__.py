"""ray_tpu_torch.dashboard — HTTP observability head.

Reference analog (SURVEY.md §2.2 Dashboard): the dashboard head
aggregates cluster state and serves it over HTTP with pluggable
modules (nodes/tasks/actors/jobs/metrics). Here: a stdlib HTTP server
in a thread exposing the state API as JSON, a Prometheus /metrics
endpoint, the chrome-trace timeline, the job REST API and a minimal
HTML overview. ``agent.NodeAgent`` is the per-node sampler every node
daemon runs; its ``gpus`` field fills the node table's column.
"""

from ray_tpu_torch.dashboard.head import Dashboard, start_dashboard

__all__ = ["Dashboard", "start_dashboard"]
