"""Classic Tune: class Trainable + callbacks + ExperimentAnalysis.

    python -m ray_tpu_torch.examples.tune_classic
"""

import os
import shutil
import tempfile

import ray_tpu_torch
from ray_tpu_torch import tune


class Quadratic(tune.Trainable):
    """Minimize (x-3)^2 by gradient steps; checkpoints its position."""

    def setup(self, config):
        self.x = 0.0
        self.lr = config["lr"]

    def step(self):
        self.x -= self.lr * 2 * (self.x - 3.0)
        return {"loss": (self.x - 3.0) ** 2,
                "done": self.iteration >= 14}

    def save_checkpoint(self, checkpoint_dir):
        with open(os.path.join(checkpoint_dir, "x.txt"), "w") as f:
            f.write(str(self.x))
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir):
        with open(os.path.join(checkpoint_dir, "x.txt")) as f:
            self.x = float(f.read())


def main() -> None:
    ray_tpu_torch.init(num_cpus=4)
    storage = tempfile.mkdtemp()
    try:
        grid = tune.run(
            Quadratic,
            config={"lr": tune.grid_search([0.05, 0.2, 0.4])},
            storage_path=storage, name="quad",
            progress_reporter=tune.CLIReporter(metric_columns=["loss"],
                                               max_report_frequency=1.0),
        )

        best = grid.get_best_result("loss", "min")
        print("best lr:", best.config["lr"], "loss:", best.metrics["loss"])

        # the journal answers the same questions without the Tuner object
        ana = tune.ExperimentAnalysis(os.path.join(storage, "quad"))
        print("analysis best config:", ana.get_best_config("loss", "min"))
        print("best checkpoint dir:", ana.get_best_checkpoint("loss", "min"))
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    print("ok")


if __name__ == "__main__":
    main()
