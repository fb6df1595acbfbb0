"""SklearnTrainer — estimator fitting as a cluster workload: the
counterpart of ``ray_tpu/train/sklearn.py``.

Reference analog: ray.train.sklearn.SklearnTrainer — sklearn doesn't
distribute a single fit, so the trainer runs it on ONE gang worker
(with the cluster handling placement/retries/reporting) and persists
the fitted estimator as a Checkpoint; ``cv`` adds cross-validation
scores to the reported metrics. The estimator fits on the CPU, so its
worker holds no card (``gpus_per_worker=0``, as the JAX module's worker
holds no chip), and the checkpoint is staged under the temporary
directory.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

from ray_tpu_torch.core.config import temp_path
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import Result, TorchTrainer

CHECKPOINT_FILE = "estimator.pkl"


class SklearnTrainer(TorchTrainer):
    def __init__(self, *, estimator: Any, datasets: dict,
                 label_column: str,
                 scoring: str | None = None,
                 cv: int | None = None,
                 run_config: RunConfig | None = None):
        def loop(config: dict) -> None:
            import numpy as np

            from ray_tpu_torch import train as rt_train

            train_ds = datasets["train"]
            batches = list(train_ds.iter_batches())
            y = np.concatenate(
                [np.asarray(b[label_column]) for b in batches])
            feat_cols = [c for c in batches[0] if c != label_column]
            X = np.concatenate([
                np.column_stack([np.asarray(b[c]) for c in feat_cols])
                for b in batches])

            metrics: dict = {"n_samples": int(len(y))}
            if cv:
                from sklearn.model_selection import cross_val_score
                scores = cross_val_score(estimator, X, y, cv=cv,
                                         scoring=scoring)
                metrics["cv_mean"] = float(scores.mean())
                metrics["cv_std"] = float(scores.std())
            est = estimator.fit(X, y)
            if scoring is None and hasattr(est, "score"):
                metrics["train_score"] = float(est.score(X, y))

            ckpt_dir = temp_path("ray_tpu_torch_sklearn_ckpt")
            os.makedirs(ckpt_dir, exist_ok=True)
            with open(os.path.join(ckpt_dir, CHECKPOINT_FILE),
                      "wb") as f:
                pickle.dump(est, f)
            rt_train.report(
                metrics,
                checkpoint=rt_train.Checkpoint.from_directory(
                    ckpt_dir))

        super().__init__(
            loop,
            scaling_config=ScalingConfig(num_workers=1, gpus_per_worker=0),
            run_config=run_config)

    @staticmethod
    def get_estimator(checkpoint) -> Any:
        """Unpickle the fitted estimator from a Result checkpoint."""
        path = os.path.join(checkpoint.path, CHECKPOINT_FILE)
        with open(path, "rb") as f:
            return pickle.load(f)
