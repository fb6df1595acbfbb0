"""TransformersTrainer — HuggingFace Trainer over the actor gang: the
counterpart of ``ray_tpu/train/huggingface.py``.

Reference analog: ray.train.huggingface (TransformersTrainer /
prepare_trainer): the user supplies ``trainer_init_per_worker(config)
-> transformers.Trainer``; each gang worker builds it AFTER the gang's
process group exists (NCCL on the card, gloo under
``ScalingConfig(gpus_per_worker=0)``), so the HF Trainer detects the
initialized torch.distributed world and runs DDP on its own. Logged
metrics stream back through ``ray_tpu_torch.train.report`` via a
TrainerCallback; the final model state saves as a Checkpoint from rank 0
(into ``__ckpt_dir__``, default the temporary directory).
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable

from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.torch import TorchTrainer


def prepare_trainer(trainer):
    """Attach the report callback to an existing transformers.Trainer
    (reference: ray.train.huggingface.transformers.prepare_trainer)."""
    import transformers

    from ray_tpu_torch import train as rt_train

    class _ReportCallback(transformers.TrainerCallback):
        def on_log(self, args, state, control, logs=None, **kwargs):
            if logs and state.is_world_process_zero:
                clean = {k: v for k, v in logs.items()
                         if isinstance(v, (int, float))}
                clean["step"] = state.global_step
                rt_train.report(clean)

    trainer.add_callback(_ReportCallback())
    return trainer


class TransformersTrainer(TorchTrainer):
    def __init__(self, trainer_init_per_worker: Callable, *,
                 train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None):
        def loop(config: dict) -> None:
            from ray_tpu_torch import train as rt_train

            trainer = prepare_trainer(
                trainer_init_per_worker(config))
            result = trainer.train()
            ctx = rt_train.get_context()
            metrics = {"final_loss":
                       float(result.training_loss)}
            if ctx.world_rank == 0:
                ckpt_dir = os.path.join(
                    config.get("__ckpt_dir__", tempfile.gettempdir()),
                    "hf_final")
                trainer.save_model(ckpt_dir)
                rt_train.report(
                    metrics,
                    checkpoint=rt_train.Checkpoint.from_directory(
                        ckpt_dir))
            else:
                rt_train.report(metrics)

        super().__init__(loop,
                         train_loop_config=train_loop_config,
                         scaling_config=scaling_config,
                         run_config=run_config)
