"""Durable workflow storage.

Counterpart of ``ray_tpu/workflow/storage.py``, on the port's
serializer. The default root is ``ray_tpu_torch_workflows`` under the
temporary directory (``/tmp/ray_tpu_torch_workflows`` unless
``TMPDIR`` says otherwise), apart from the JAX package's
``/tmp/ray_tpu_workflows``: the two packages never share a store.

Reference: python/ray/workflow/workflow_storage.py — step-level durable
logging under a filesystem root so a crashed workflow resumes from its
last completed step. Layout:

    <root>/<workflow_id>/meta.json           status + dag hash
    <root>/<workflow_id>/steps/<step_key>.pkl   cached step results
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any

from ray_tpu_torch.core import serialization as ser

_DEFAULT_ROOT = os.path.join(tempfile.gettempdir(),
                             "ray_tpu_torch_workflows")
_lock = threading.Lock()
_root: str | None = None


def set_root(path: str) -> None:
    global _root
    with _lock:
        _root = path
        os.makedirs(path, exist_ok=True)


def get_root() -> str:
    global _root
    with _lock:
        if _root is None:
            _root = _DEFAULT_ROOT
            os.makedirs(_root, exist_ok=True)
        return _root


class WorkflowStorage:
    def __init__(self, workflow_id: str):
        self.workflow_id = workflow_id
        self.dir = os.path.join(get_root(), workflow_id)
        self.steps_dir = os.path.join(self.dir, "steps")
        os.makedirs(self.steps_dir, exist_ok=True)
        self._meta_path = os.path.join(self.dir, "meta.json")

    # -- metadata -------------------------------------------------------

    def save_meta(self, meta: dict) -> None:
        # unique tmp per writer: cancel() (caller thread) and the run
        # thread can save concurrently — a SHARED tmp name makes one
        # writer's os.replace race the other's (caught by the cancel
        # drive: FileNotFoundError on the second replace)
        tmp = (f"{self._meta_path}.{os.getpid()}."
               f"{threading.get_ident()}.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path)  # atomic

    def load_meta(self) -> dict | None:
        try:
            with open(self._meta_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    # -- step results ---------------------------------------------------

    def _step_path(self, step_key: str) -> str:
        return os.path.join(self.steps_dir, f"{step_key}.pkl")

    def has_step(self, step_key: str) -> bool:
        return os.path.exists(self._step_path(step_key))

    def save_step(self, step_key: str, value: Any) -> None:
        tmp = (f"{self._step_path(step_key)}.{os.getpid()}."
               f"{threading.get_ident()}.tmp")  # unique per writer
        with open(tmp, "wb") as f:
            f.write(ser.dumps(value))
        os.replace(tmp, self._step_path(step_key))

    def load_step(self, step_key: str) -> Any:
        with open(self._step_path(step_key), "rb") as f:
            return ser.loads(f.read())


def list_workflows() -> list[str]:
    root = get_root()
    try:
        return sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
    except FileNotFoundError:
        return []
