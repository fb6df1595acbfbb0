"""DQN: off-policy Q-learning with replay and a target network, on the port.

Counterpart of ``ray_tpu/rllib/dqn.py``. Reference analog:
rllib/algorithms/dqn/ (new API stack: EnvRunners sample with
epsilon-greedy, a Learner does TD updates from a replay buffer, the
target net is synced periodically). The TD minibatch update (double-Q
target, Huber loss with δ = 1, Adam) is one step of
``train.step.make_train_step``, captured on the card as one CUDA graph;
the target network's parameters are the step's ``extra`` (read through
``torch.func.functional_call``, copied in place at each sync, so the graph
goes on reading the same tensors). The replay buffer is host-side numpy,
copied from the JAX package, and samples its indices from the same
``np.random.default_rng(seed)``, so the two packages draw equal
minibatches.

The learner runs on the card unless the config asks otherwise
(``.learners(device="cpu")``); the runners stay on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.rllib.algorithm import LearnersConfig
from ray_tpu_torch.rllib.catalog import build_q_network
from ray_tpu_torch.rllib.checkpoints import Checkpointable, tree_to_host
from ray_tpu_torch.rllib.env_runner import (
    EnvRunnerGroup, SupportsEvaluation,
)
from ray_tpu_torch.rllib.learner import (
    ModelLearner, adam_load, adam_view, as_tensor, batch_to_device,
    full_float32,
)
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.train.step import init_train_state, make_train_step


@dataclass
class DQNHyperparams:
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_size: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    num_gradient_steps: int = 8      # per train() call
    target_update_freq: int = 4      # in train() calls
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_iters: int = 20
    double_q: bool = True


class ReplayBuffer:
    """Circular numpy transition store (host RAM — the reference's
    EpisodeReplayBuffer analog)."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self._i = 0
        self.size = 0

    def add_episodes(self, episodes) -> int:
        n = 0
        for ep in episodes:
            obs_seq = ep.obs + [ep.final_obs]
            for t in range(ep.length):
                done = float(ep.terminated and t == ep.length - 1)
                self._add(obs_seq[t], ep.actions[t], ep.rewards[t],
                          obs_seq[t + 1], done)
                n += 1
        return n

    def _add(self, o, a, r, o2, d) -> None:
        i = self._i
        self.obs[i], self.actions[i] = o, a
        self.rewards[i], self.next_obs[i], self.dones[i] = r, o2, d
        self._i = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, batch_size: int, rng) -> dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, batch_size)
        return {"obs": self.obs[idx], "actions": self.actions[idx],
                "rewards": self.rewards[idx],
                "next_obs": self.next_obs[idx],
                "dones": self.dones[idx]}


def huber_loss(errors: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """optax.huber_loss: 0.5·min(|e|, δ)² + δ·(|e| − min(|e|, δ))."""
    abs_errors = errors.abs()
    quadratic = torch.clamp(abs_errors, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_errors - quadratic)


class DQNLearner(ModelLearner):
    def __init__(self, policy_config: dict, hp: DQNHyperparams,
                 seed: int = 0, device=None):
        self.hp = hp
        self.device = resolve_device(device)
        self.model = build_q_network(policy_config, self.device, seed)
        self.opt = adamw(hp.lr, weight_decay=0.0)
        self.state = init_train_state(
            self.model, self.opt,
            extra={k: p.detach().clone() for k, p in self.params.items()})
        self._update = make_train_step(self._loss, self.opt, has_extra=True,
                                       grad_norm=False, has_aux=True)

    @property
    def target_params(self) -> dict[str, torch.Tensor]:
        """The target network's parameters by name (the step's extra)."""
        return self.state.extra

    @target_params.setter
    def target_params(self, weights) -> None:
        with torch.no_grad():
            for k, t in self.state.extra.items():
                t.copy_(as_tensor(weights[k]))

    @property
    def opt_state(self) -> dict:
        """Adam's state as ``{"count", "mu": [...], "nu": [...]}`` of live
        tensors; assigning one copies it in, in place."""
        return adam_view(self.state.opt_state)

    @opt_state.setter
    def opt_state(self, st: dict) -> None:
        adam_load(self.state.opt_state, st)

    def _loss(self, model, target, batch):
        hp = self.hp
        q = model(batch["obs"])
        q_sa = q.gather(-1, batch["actions"].long()[:, None])[:, 0]
        with torch.no_grad():
            q_next_t = functional_call(model, target, (batch["next_obs"],))
            if hp.double_q:
                # online net picks the argmax, target net evaluates it
                a_star = torch.argmax(model(batch["next_obs"]), dim=-1)
                q_next = q_next_t.gather(-1, a_star[:, None])[:, 0]
            else:
                q_next = q_next_t.max(dim=-1).values
            y = batch["rewards"] + hp.gamma * (1.0 - batch["dones"]) * q_next
        td = q_sa - y
        return (torch.mean(huber_loss(td)), {},
                {"td_error": torch.mean(td.abs()).detach()})

    def update(self, batch: dict[str, np.ndarray]) -> dict:
        with full_float32():
            self.state, metrics = self._update(
                self.state, batch_to_device(batch, self.device))
        return {"td_error": float(metrics["td_error"]),
                "loss": float(metrics["loss"])}

    def sync_target(self) -> None:
        self.target_params = self.params


@dataclass
class DQNConfig(LearnersConfig):
    env: Any = None
    policy_config: dict = field(default_factory=dict)
    num_env_runners: int = 2
    rollout_fragment_length: int = 128
    hparams: DQNHyperparams = field(default_factory=DQNHyperparams)
    seed: int = 0
    device: Any = None                      # the learner's; None: the card

    def environment(self, env, *, obs_dim: int, num_actions: int,
                    hidden: tuple = (64, 64)) -> "DQNConfig":
        return replace(self, env=env, policy_config={
            "obs_dim": obs_dim, "num_actions": num_actions,
            "hidden": hidden})

    def env_runners(self, num_env_runners: int) -> "DQNConfig":
        return replace(self, num_env_runners=num_env_runners)

    def training(self, **hp_overrides) -> "DQNConfig":
        return replace(self, hparams=replace(self.hparams,
                                             **hp_overrides))

    def build(self) -> "DQN":
        return DQN(self)


class DQN(Checkpointable, SupportsEvaluation):
    def __init__(self, config: DQNConfig):
        assert config.env is not None
        self.config = config
        hp = config.hparams
        self.learner = DQNLearner(config.policy_config, hp,
                                  seed=config.seed, device=config.device)
        self.runners = EnvRunnerGroup(
            config.env, config.policy_config,
            num_runners=config.num_env_runners, seed=config.seed,
            policy="epsilon_greedy")
        self.buffer = ReplayBuffer(hp.buffer_size,
                                   config.policy_config["obs_dim"])
        self.rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self.runners.set_weights(self.learner.get_weights())

    def get_state(self) -> dict:
        """Learner params + target net + optimizer + iteration.
        The replay buffer is deliberately NOT checkpointed (same
        default as the reference: fresh buffer on resume)."""
        return {
            "iteration": self.iteration,
            "learner": {
                "params": tree_to_host(self.learner.params),
                "target_params": tree_to_host(
                    self.learner.target_params),
                "opt_state": tree_to_host(self.learner.opt_state),
            },
        }

    def set_state(self, state: dict) -> None:
        self.iteration = int(state["iteration"])
        lst = state["learner"]
        # Copied into the learner's tensors in place: a captured update
        # goes on writing the same ones.
        self.learner.params = lst["params"]
        self.learner.target_params = lst["target_params"]
        self.learner.opt_state = lst["opt_state"]
        self.runners.set_weights(self.learner.get_weights())

    def _epsilon(self) -> float:
        hp = self.config.hparams
        frac = min(1.0, self.iteration / max(1, hp.epsilon_decay_iters))
        return hp.epsilon_initial + frac * (hp.epsilon_final
                                            - hp.epsilon_initial)

    def train(self) -> dict:
        hp = self.config.hparams
        t0 = time.time()
        self.runners.set_epsilon(self._epsilon())
        episodes = self.runners.sample(
            self.config.rollout_fragment_length)
        added = self.buffer.add_episodes(episodes)
        sample_time = time.time() - t0

        metrics: dict = {}
        t1 = time.time()
        if self.buffer.size >= hp.learning_starts:
            for _ in range(hp.num_gradient_steps):
                batch = self.buffer.sample(hp.train_batch_size,
                                           self.rng)
                metrics = self.learner.update(batch)
            if (self.iteration + 1) % hp.target_update_freq == 0:
                self.learner.sync_target()
            self.runners.set_weights(self.learner.get_weights())
        learn_time = time.time() - t1

        self.iteration += 1
        finished = [e for e in episodes if e.terminated or e.truncated]
        mean_reward = (sum(e.total_reward for e in finished)
                       / len(finished)) if finished else float("nan")
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": mean_reward,
            "episodes_this_iter": len(finished),
            "num_env_steps_sampled": added,
            "buffer_size": self.buffer.size,
            "epsilon": round(self._epsilon(), 4),
            "time_sample_s": round(sample_time, 3),
            "time_learn_s": round(learn_time, 3),
            **metrics,
        }

    def evaluate(self, num_episodes: int = 10) -> dict:
        """Greedy-policy evaluation: epsilon forced to 0 for the
        eval rounds and restored after (reference: Algorithm.evaluate
        runs with explore=False — the training epsilon would make
        this measure the exploration policy, not the learned one)."""
        self.runners.set_epsilon(0.0)
        try:
            return super().evaluate(num_episodes)
        finally:
            self.runners.set_epsilon(self._epsilon())

    def stop(self) -> None:
        self.runners.shutdown()
