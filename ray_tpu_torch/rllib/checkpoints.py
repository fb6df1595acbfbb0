"""Algorithm checkpointing (reference: the ``Checkpointable`` mixin,
``rllib/utils/checkpoints.py`` — Algorithm/Learner components save and
restore their state trees so long trainings resume).

Counterpart of ``ray_tpu/rllib/checkpoints.py``. The mixin works over a
``get_state()``/``set_state()`` contract and writes through
``ray_tpu_torch.util.storage``, so a checkpoint lands on
local disk or any registered scheme (``mock-s3://…``, real clouds) the
same way train checkpoints do.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

from ray_tpu_torch.util.storage import is_uri, storage_for_uri, uri_join

_STATE_FILE = "algorithm_state.pkl"


class Checkpointable:
    """save_to_path / restore_from_path / from_checkpoint over a
    get_state/set_state contract."""

    def get_state(self) -> dict:
        raise NotImplementedError

    def set_state(self, state: dict) -> None:
        raise NotImplementedError

    def save_to_path(self, path: str) -> str:
        blob = pickle.dumps(self.get_state())
        if is_uri(path):
            uri = uri_join(path, _STATE_FILE)
            storage_for_uri(uri).write_bytes(uri, blob)
            return path
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _STATE_FILE), "wb") as f:
            f.write(blob)
        return path

    def save(self, checkpoint_dir: str | None = None) -> str:
        """Classic alias (reference: Algorithm.save, which writes
        into the algorithm's logdir): with no dir, saves are numbered
        under ONE stable per-instance directory — repeated save()
        calls in a training loop don't scatter /tmp, and the returned
        path of the latest call is always the newest checkpoint."""
        if checkpoint_dir is None:
            base = getattr(self, "_default_ckpt_dir", None)
            if base is None:
                import tempfile
                base = tempfile.mkdtemp(prefix="rllib_ckpt_")
                self._default_ckpt_dir = base
                self._default_ckpt_seq = 0
            self._default_ckpt_seq += 1
            import os as _os
            checkpoint_dir = _os.path.join(
                base, f"checkpoint_{self._default_ckpt_seq:06d}")
        return self.save_to_path(checkpoint_dir)

    def restore(self, checkpoint_path: str) -> None:
        """Classic alias (reference: Algorithm.restore)."""
        self.restore_from_path(checkpoint_path)

    def restore_from_path(self, path: str) -> None:
        if is_uri(path):
            uri = uri_join(path, _STATE_FILE)
            blob = storage_for_uri(uri).read_bytes(uri)
        else:
            with open(os.path.join(path, _STATE_FILE), "rb") as f:
                blob = f.read()
        self.set_state(pickle.loads(blob))

    @classmethod
    def from_checkpoint(cls, path: str, config: Any):
        """Build a fresh algorithm from ``config`` and restore the
        checkpointed state into it (reference:
        Algorithm.from_checkpoint)."""
        algo = (config.build() if hasattr(config, "build")
                else cls(config))
        algo.restore_from_path(path)
        return algo


def tree_to_host(tree):
    """Tensors (on any device), and dicts, lists and tuples of them ->
    the same structure of plain numpy arrays (picklable,
    device-independent); other leaves as they are."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: tree_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_host(v) for v in tree)
    return tree
