"""BC — behavior cloning from offline data, on the port.

Counterpart of ``ray_tpu/rllib/bc.py``. Reference analog:
rllib/algorithms/bc/ (offline RL entry point: train a policy by
supervised learning on logged (obs, action) pairs read through the data
layer). Offline data flows through ``ray_tpu_torch.data``: a Dataset with
"obs" and "action" columns is read once, and each minibatch (indices from
``np.random.default_rng(seed)``, as in the JAX package) goes through one
cross-entropy update, a step of ``train.step.make_train_step`` captured
on the card as one CUDA graph. The learner runs on the card unless the
config asks otherwise (``.learners(device="cpu")``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.rllib.algorithm import LearnersConfig
from ray_tpu_torch.rllib.catalog import build_actor_critic
from ray_tpu_torch.rllib.learner import (
    ModelLearner, batch_to_device, full_float32,
)
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.train.step import init_train_state, make_train_step


@dataclass
class BCHyperparams:
    lr: float = 1e-3
    train_batch_size: int = 256
    num_gradient_steps: int = 16    # per train() call


class BCLearner(ModelLearner):
    def __init__(self, policy_config: dict, hp: BCHyperparams,
                 seed: int = 0, device=None):
        self.hp = hp
        self.device = resolve_device(device)
        self.model = build_actor_critic(policy_config, self.device, seed)
        self.opt = adamw(hp.lr, weight_decay=0.0)
        self.state = init_train_state(self.model, self.opt)
        self._update = make_train_step(self._loss, self.opt,
                                       grad_norm=False, has_aux=True)

    def _loss(self, model, batch):
        logits, _ = model(batch["obs"])
        logp = F.log_softmax(logits, dim=-1)
        action = batch["action"].long()
        nll = -logp.gather(-1, action[:, None])[:, 0]
        acc = torch.mean((torch.argmax(logits, -1) == action).float())
        return nll.mean(), {"accuracy": acc.detach()}

    def update(self, batch: dict[str, np.ndarray]) -> dict:
        mb = batch_to_device(
            {"obs": np.asarray(batch["obs"], np.float32),
             "action": np.asarray(batch["action"], np.int64)}, self.device)
        with full_float32():
            self.state, metrics = self._update(self.state, mb)
        return {"loss": float(metrics["loss"]),
                "accuracy": float(metrics["accuracy"])}


@dataclass
class BCConfig(LearnersConfig):
    dataset: Any = None             # ray_tpu_torch.data.Dataset
    policy_config: dict = field(default_factory=dict)
    hparams: BCHyperparams = field(default_factory=BCHyperparams)
    seed: int = 0
    device: Any = None                      # the learner's; None: the card

    def environment(self, *, obs_dim: int, num_actions: int,
                    hidden: tuple = (64, 64)) -> "BCConfig":
        return replace(self, policy_config={
            "obs_dim": obs_dim, "num_actions": num_actions,
            "hidden": hidden})

    def offline_data(self, dataset) -> "BCConfig":
        """A Dataset with "obs" (float [D] rows) and "action" (int)
        columns (reference: AlgorithmConfig.offline_data)."""
        return replace(self, dataset=dataset)

    def training(self, **hp_overrides) -> "BCConfig":
        return replace(self, hparams=replace(self.hparams,
                                             **hp_overrides))

    def build(self) -> "BC":
        return BC(self)


class BC:
    def __init__(self, config: BCConfig):
        assert config.dataset is not None, "call .offline_data(ds)"
        assert config.policy_config, "call .environment(...)"
        self.config = config
        self.learner = BCLearner(config.policy_config, config.hparams,
                                 seed=config.seed, device=config.device)
        self.rng = np.random.default_rng(config.seed)
        self.iteration = 0
        # Materialize the offline dataset once (epochs reshuffle it).
        batches = list(config.dataset.iter_batches())
        self._obs = np.concatenate(
            [np.asarray(b["obs"], np.float32) for b in batches])
        self._act = np.concatenate(
            [np.asarray(b["action"], np.int64) for b in batches])

    def train(self) -> dict:
        hp = self.config.hparams
        t0 = time.time()
        metrics: dict = {}
        n = len(self._obs)
        for _ in range(hp.num_gradient_steps):
            idx = self.rng.integers(0, n, hp.train_batch_size)
            metrics = self.learner.update(
                {"obs": self._obs[idx], "action": self._act[idx]})
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "num_samples": n,
                "time_learn_s": round(time.time() - t0, 3),
                **metrics}

    def evaluate(self, env_maker, num_episodes: int = 5) -> dict:
        """Roll out the greedy policy in a live env."""
        rewards = []
        params = self.learner.params
        for ep in range(num_episodes):
            env = env_maker()
            obs, _ = env.reset(seed=ep)
            total, done = 0.0, False
            while not done:
                logits = self.model_apply(
                    params, np.asarray(obs, np.float32)[None])
                action = int(np.argmax(np.asarray(logits[0])))
                obs, r, term, trunc, _ = env.step(action)
                total += float(r)
                done = term or trunc
            rewards.append(total)
        return {"episode_reward_mean": float(np.mean(rewards))}

    def model_apply(self, params, obs):
        """Logits of ``obs`` (numpy) under ``params`` (by name), as numpy."""
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.learner.device)
        with torch.no_grad(), full_float32():
            logits, _ = functional_call(self.learner.model, params, (obs,))
        return logits.float().cpu().numpy()

    def stop(self) -> None:
        pass
