"""Algorithm: the training driver (reference: Algorithm.training_step,
ppo.py:402 — sample via EnvRunnerGroup, update via Learner, broadcast
weights).

Counterpart of ``ray_tpu/rllib/algorithm.py``: ``PPO`` with its learner
on the card (``TorchLearner``) and its env runners on the CPU. The
config's ``device`` is the learner's device (``.learners(device=...)``):
the card by default, raising where none is visible, ``"cpu"`` when
asked — the port's one addition to the config, forced by the card.
``compute_single_action(explore=True)`` samples from a
``torch.Generator`` seeded with ``seed + 2`` where the JAX one splits
``jax.random.key(seed + 2)``: equal in distribution, not in stream.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

from ray_tpu_torch.rllib.env_runner import (
    EnvRunnerGroup, SupportsEvaluation,
)
from ray_tpu_torch.rllib.checkpoints import Checkpointable, tree_to_host
from ray_tpu_torch.rllib.learner import (
    PPOHyperparams, TorchLearner, full_float32,
)


class LearnersConfig:
    """``learners(device=...)`` for a config dataclass with a ``device``
    field: the learner's device, the port's one addition to each
    algorithm's config."""

    def learners(self, *, device=None):
        """The learner's device (reference: AlgorithmConfig.learners):
        ``"cpu"``, or a card; None (the default) is ``cuda:0``."""
        return replace(self, device=device)


@dataclass
class AlgorithmConfig(LearnersConfig):
    """Fluent config builder (reference: AlgorithmConfig)."""

    env: Any = None                         # name or callable
    policy_config: dict = field(default_factory=dict)
    num_env_runners: int = 2
    train_batch_size: int = 512
    hparams: PPOHyperparams = field(default_factory=PPOHyperparams)
    seed: int = 0
    env_to_module: list = field(default_factory=list)
    module_to_env: list = field(default_factory=list)
    device: Any = None                      # the learner's; None: the card

    def environment(self, env, *, obs_dim: int, num_actions: int,
                    hidden: tuple = (64, 64)) -> "AlgorithmConfig":
        return replace(self, env=env, policy_config={
            "obs_dim": obs_dim, "num_actions": num_actions,
            "hidden": hidden})

    def env_runners(self, num_env_runners: int) -> "AlgorithmConfig":
        return replace(self, num_env_runners=num_env_runners)

    def connectors(self, *, env_to_module: list | None = None,
                   module_to_env: list | None = None
                   ) -> "AlgorithmConfig":
        """ConnectorV2 pipelines for the env runners (reference:
        AlgorithmConfig.env_to_module_connector /
        module_to_env_connector of the new API stack)."""
        return replace(
            self,
            env_to_module=list(env_to_module
                               or self.env_to_module),
            module_to_env=list(module_to_env
                               or self.module_to_env))

    def training(self, *, train_batch_size: int | None = None,
                 **hp_overrides) -> "AlgorithmConfig":
        hp = replace(self.hparams, **hp_overrides)
        return replace(
            self, hparams=hp,
            train_batch_size=train_batch_size or self.train_batch_size)

    def build(self) -> "PPO":
        return PPO(self)


PPOConfig = AlgorithmConfig


class PPO(Checkpointable, SupportsEvaluation):
    """Proximal Policy Optimization on the new-API-stack layout."""

    def __init__(self, config: AlgorithmConfig):
        assert config.env is not None, "call .environment(...) first"
        self.config = config
        self.learner = TorchLearner(config.policy_config, config.hparams,
                                    seed=config.seed, device=config.device)
        self.runners = EnvRunnerGroup(
            config.env, config.policy_config,
            num_runners=config.num_env_runners, seed=config.seed,
            env_to_module=config.env_to_module,
            module_to_env=config.module_to_env)
        self.iteration = 0
        # Sync initial weights so sampling matches the learner.
        self.runners.set_weights(self.learner.get_weights())

    def train(self) -> dict:
        """One training iteration (reference: training_step)."""
        t0 = time.time()
        per_runner = max(
            1, self.config.train_batch_size
            // max(1, self.config.num_env_runners))
        episodes = self.runners.sample(per_runner)
        sample_time = time.time() - t0

        t1 = time.time()
        metrics = self.learner.update_from_episodes(episodes)
        learn_time = time.time() - t1

        self.runners.set_weights(self.learner.get_weights())
        self.iteration += 1

        finished = [e for e in episodes if e.terminated or e.truncated]
        mean_reward = (sum(e.total_reward for e in finished)
                       / len(finished)) if finished else float("nan")
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": mean_reward,
            "episodes_this_iter": len(finished),
            "num_env_steps_sampled": sum(e.length for e in episodes),
            "time_sample_s": round(sample_time, 3),
            "time_learn_s": round(learn_time, 3),
            **metrics,
        }

    def get_state(self) -> dict:
        """Checkpointable state: learner params + optimizer state +
        iteration (reference: Algorithm.save_to_path components)."""
        return {
            "iteration": self.iteration,
            "learner": {
                "params": tree_to_host(self.learner.params),
                "opt_state": tree_to_host(self.learner.opt_state),
            },
        }

    def set_state(self, state: dict) -> None:
        self.iteration = int(state["iteration"])
        # Copied into the learner's tensors in place: a captured update
        # goes on writing the same ones.
        self.learner.params = state["learner"]["params"]
        self.learner.opt_state = state["learner"]["opt_state"]
        self.runners.set_weights(self.learner.get_weights())

    def compute_single_action(self, obs, explore: bool = False):
        """Inference on one RAW observation (reference:
        Algorithm.compute_single_action): the configured
        env_to_module connectors run first — the model must see the
        same transformed inputs it trained on; greedy argmax by
        default, sampled (seeded, reproducible) with
        ``explore=True``."""
        import numpy as np
        import torch

        from ray_tpu_torch.rllib.connectors import ConnectorPipelineV2
        if not hasattr(self, "_inference_pipeline"):
            self._inference_pipeline = ConnectorPipelineV2(
                self.config.env_to_module)
            # persistent generator, the counterpart of the split key
            self._action_gen = torch.Generator().manual_seed(
                self.config.seed + 2)
        obs = np.asarray(self._inference_pipeline(obs), np.float32)
        with torch.inference_mode(), full_float32():
            logits, _ = self.learner.model(
                torch.from_numpy(obs)[None].to(self.learner.device))
        logits = logits[0].float().cpu()
        if explore:
            return int(torch.multinomial(torch.softmax(logits, -1), 1,
                                         generator=self._action_gen))
        return int(np.argmax(logits.numpy()))

    def stop(self) -> None:
        self.runners.shutdown()

    # -- Tune integration: PPO as a trainable --

    @staticmethod
    def as_trainable(config_builder: Callable[[dict], AlgorithmConfig],
                     num_iterations: int = 10):
        def trainable(tune_config: dict):
            from ray_tpu_torch.train import report
            algo = config_builder(tune_config).build()
            try:
                for _ in range(num_iterations):
                    report(algo.train())
            finally:
                algo.stop()
        return trainable
