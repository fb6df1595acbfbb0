"""Dataset: read -> transform -> shuffle -> iterate.

    python -m ray_tpu_torch.examples.data_pipeline
"""

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import data


def main() -> None:
    ray_tpu_torch.init(num_cpus=4)
    ds = (data.range(1000)
          .map_batches(lambda b: {"x": [v * 2 for v in b["id"]]})
          .filter(lambda row: row["x"] % 40 == 0)
          .random_shuffle(seed=7))
    print("count:", ds.count())
    print("take:", ds.take(5))

    # feed a training loop in batches (iter_device_batches places them
    # on the card)
    for batch in ds.iter_batches(batch_size=8):
        arr = np.asarray(batch["x"])
        break
    print("first batch:", arr)
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
