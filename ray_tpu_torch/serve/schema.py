"""Declarative Serve config schema (reference:
``python/ray/serve/schema.py`` — ServeDeploySchema / ServeApplication
Schema / DeploymentSchema pydantic models behind ``serve deploy``).

Re-based on plain dataclasses + explicit validation: the shape is the
same — a deploy config lists applications, each importing a bound
``Application`` (``module:attr``) with optional per-deployment
overrides — but validation errors surface as ``ValueError`` with the
offending field path, no pydantic dependency.

YAML example::

    http_options:
      port: 8080
    applications:
      - name: text_app
        route_prefix: /text
        import_path: my_module:app
        deployments:
          - name: Summarizer
            num_replicas: 3
            autoscaling_config: {min_replicas: 1, max_replicas: 5}
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "DeploymentOverride", "ServeApplicationSchema", "ServeDeploySchema",
    "load_config", "parse_config",
]


@dataclass
class DeploymentOverride:
    """Per-deployment override applied onto the imported Deployment."""
    name: str
    num_replicas: int | None = None
    ray_actor_options: dict | None = None
    autoscaling_config: dict | None = None
    user_config: Any = None
    max_ongoing_requests: int | None = None

    @staticmethod
    def from_dict(d: dict, where: str) -> "DeploymentOverride":
        if not isinstance(d, dict):
            raise ValueError(f"{where}: expected a mapping, got {d!r}")
        unknown = set(d) - {"name", "num_replicas",
                            "ray_actor_options", "autoscaling_config",
                            "user_config", "max_ongoing_requests"}
        if unknown:
            raise ValueError(
                f"{where}: unknown field(s) {sorted(unknown)}")
        if "name" not in d:
            raise ValueError(f"{where}: 'name' is required")
        nr = d.get("num_replicas")
        if nr is not None and (not isinstance(nr, int) or nr < 0):
            raise ValueError(
                f"{where}.num_replicas: expected int >= 0, got {nr!r}")
        moq = d.get("max_ongoing_requests")
        if moq is not None and (not isinstance(moq, int) or moq < 1):
            raise ValueError(
                f"{where}.max_ongoing_requests: expected int >= 1, "
                f"got {moq!r}")
        return DeploymentOverride(
            name=d["name"], num_replicas=nr,
            ray_actor_options=d.get("ray_actor_options"),
            autoscaling_config=d.get("autoscaling_config"),
            user_config=d.get("user_config"),
            max_ongoing_requests=moq)


@dataclass
class ServeApplicationSchema:
    name: str
    import_path: str
    route_prefix: str = "/"
    deployments: list[DeploymentOverride] = field(default_factory=list)

    @staticmethod
    def from_dict(d: dict, idx: int) -> "ServeApplicationSchema":
        where = f"applications[{idx}]"
        if not isinstance(d, dict):
            raise ValueError(f"{where}: expected a mapping, got {d!r}")
        unknown = set(d) - {"name", "import_path", "route_prefix",
                            "deployments"}
        if unknown:
            raise ValueError(
                f"{where}: unknown field(s) {sorted(unknown)}")
        for req in ("name", "import_path"):
            if not d.get(req):
                raise ValueError(f"{where}: {req!r} is required")
        ip = d["import_path"]
        if ":" not in ip:
            raise ValueError(
                f"{where}.import_path: expected 'module:attribute', "
                f"got {ip!r}")
        rp = d.get("route_prefix", "/")
        if not rp.startswith("/"):
            raise ValueError(
                f"{where}.route_prefix: must start with '/', got {rp!r}")
        deps = [DeploymentOverride.from_dict(
                    x, f"{where}.deployments[{i}]")
                for i, x in enumerate(d.get("deployments") or [])]
        return ServeApplicationSchema(
            name=d["name"], import_path=ip, route_prefix=rp,
            deployments=deps)

    def import_target(self):
        """Resolve import_path to the bound Application object."""
        mod_name, attr = self.import_path.split(":", 1)
        mod = importlib.import_module(mod_name)
        target = mod
        for part in attr.split("."):
            target = getattr(target, part)
        return target


@dataclass
class ServeDeploySchema:
    applications: list[ServeApplicationSchema]
    http_options: dict = field(default_factory=dict)
    grpc_options: dict = field(default_factory=dict)

    @staticmethod
    def from_dict(d: dict) -> "ServeDeploySchema":
        if not isinstance(d, dict):
            raise ValueError(f"config root: expected mapping, got {d!r}")
        unknown = set(d) - {"applications", "http_options",
                            "grpc_options"}
        if unknown:
            raise ValueError(
                f"config root: unknown field(s) {sorted(unknown)}")
        apps_raw = d.get("applications")
        if not isinstance(apps_raw, list) or not apps_raw:
            raise ValueError(
                "config root: 'applications' must be a non-empty list")
        apps = [ServeApplicationSchema.from_dict(a, i)
                for i, a in enumerate(apps_raw)]
        names = [a.name for a in apps]
        if len(set(names)) != len(names):
            raise ValueError(
                f"applications: duplicate names in {names}")
        prefixes = [a.route_prefix for a in apps]
        if len(set(prefixes)) != len(prefixes):
            raise ValueError(
                f"applications: duplicate route_prefix in {prefixes}")
        return ServeDeploySchema(
            applications=apps,
            http_options=d.get("http_options") or {},
            grpc_options=d.get("grpc_options") or {})


def parse_config(data: dict) -> ServeDeploySchema:
    return ServeDeploySchema.from_dict(data)


def load_config(path: str) -> ServeDeploySchema:
    import yaml
    with open(path) as f:
        return parse_config(yaml.safe_load(f))
