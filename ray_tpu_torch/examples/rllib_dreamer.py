"""Dreamer: world model + imagination-trained actor-critic.

    python -m ray_tpu_torch.examples.rllib_dreamer [--device cpu]

The learner runs on the card unless ``--device`` names another device.
"""

import argparse

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib import DreamerConfig


class ChainEnv:
    N = 6

    def __init__(self):
        self.pos = 0
        self.t = 0

    def _obs(self):
        o = np.zeros(self.N, np.float32)
        o[self.pos] = 1.0
        return o

    def reset(self, seed=None):
        self.pos, self.t = 0, 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        self.pos = max(0, min(self.N - 1,
                              self.pos + (1 if action == 1 else -1)))
        term = self.pos == self.N - 1
        trunc = self.t >= 20 and not term
        return self._obs(), (1.0 if term else -0.01), term, trunc, {}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the learner's device (default: the card)")
    args = ap.parse_args(argv)
    ray_tpu_torch.init(num_cpus=4)
    algo = (DreamerConfig()
            .environment(ChainEnv, obs_dim=ChainEnv.N, num_actions=2)
            .training(learning_starts=100, wm_updates_per_iter=4)
            .learners(device=args.device)
            .build())
    for i in range(6):
        r = algo.train()
        print(f"iter {i}: wm_loss={r.get('wm_loss', float('nan')):.3f} "
              f"imag_return={r.get('imag_return', float('nan')):.3f} "
              f"reward_mean={r['episode_reward_mean']:.3f}")
    algo.stop()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
