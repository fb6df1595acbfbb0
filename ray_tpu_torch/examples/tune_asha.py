"""Tuner + ASHA early stopping.

    python -m ray_tpu_torch.examples.tune_asha
"""

import ray_tpu_torch
from ray_tpu_torch import tune


def objective(config):
    from ray_tpu_torch.train import report
    acc = 0.0
    for step in range(20):
        acc += config["lr"] * (1.0 - acc)      # toy learning curve
        report({"acc": acc, "step": step})


def main() -> None:
    ray_tpu_torch.init(num_cpus=4)
    tuner = tune.Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.01, 0.05, 0.1, 0.3])},
        tune_config=tune.TuneConfig(
            metric="acc", mode="max",
            scheduler=tune.ASHAScheduler(metric="acc", mode="max",
                                         max_t=20)),
    )
    results = tuner.fit()
    best = results.get_best_result(metric="acc", mode="max")
    print("best lr:", best.config["lr"], "acc:", round(
        best.metrics["acc"], 4))
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
