"""Serve applications for ``cli serve deploy`` (tests/torch_cli_programs.py
``serve_deploy_status_and_up``), one per package: ``import_path``
``torch_cli_serve_apps:echo_<package>``. Built on first access, so that
importing this module loads neither package."""

from __future__ import annotations

import importlib


def __getattr__(name: str):
    if not name.startswith("echo_"):
        raise AttributeError(name)
    serve = importlib.import_module(f"{name[len('echo_'):]}.serve")

    @serve.deployment(num_replicas=1)
    class Echo:
        def __call__(self, x):
            return {"echo": x}

    return Echo.bind()
