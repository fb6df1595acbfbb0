"""SAC: soft actor-critic for continuous control, on the port.

Counterpart of ``ray_tpu/rllib/sac.py``. Reference analog:
rllib/algorithms/sac/ — off-policy maximum-entropy RL: tanh-gaussian
actor, twin Q critics with clipped double-Q targets, polyak-averaged
target critics, and automatic entropy-temperature tuning against a target
entropy of -|A|. The critic, actor and temperature updates and the polyak
step of one minibatch are ONE step (``train.step.make_step``: one CUDA
graph on the card, the counterpart of the JAX learner's one ``jit``):
critic first, then the actor against the critic as the critic's update
left it, then the temperature from the actor loss's mean log-prob, then
the target. The replay buffer stays host-side numpy and samples its
indices from ``np.random.default_rng(seed)``, as the JAX package does.

Noise is an input of the step: the learner draws the gaussian noise of
its two samples from its own ``torch.Generator`` on its device (seeded
``seed + 1``, where the JAX driver splits ``jax.random.key(seed + 1)``:
equal in distribution, not in stream) and passes it in with the batch,
so a captured step replays with fresh noise and a test can feed JAX's own
draws (``update(batch, noise=...)``). The learner runs on the card unless
the config asks otherwise (``.learners(device="cpu")``); the runners stay
on the CPU.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.rllib.algorithm import LearnersConfig
from ray_tpu_torch.rllib.catalog import load_flax_tree
from ray_tpu_torch.rllib.env_runner import (
    EnvRunnerGroup, SupportsEvaluation,
)
from ray_tpu_torch.rllib.learner import (
    as_tensor, batch_to_device, full_float32, load_weights,
)
from ray_tpu_torch.rllib.models import (
    ContinuousConfig, SquashedGaussianActor, TwinQ,
)
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.train.step import TrainState, compile_count, make_step


@dataclass
class SACHyperparams:
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005              # polyak target rate
    buffer_size: int = 100_000
    learning_starts: int = 500
    train_batch_size: int = 128
    num_gradient_steps: int = 8
    init_alpha: float = 0.1


class ContinuousReplayBuffer:
    def __init__(self, capacity: int, obs_dim: int, action_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity, action_dim), np.float32)
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
                i = self._i
                self.obs[i] = obs_seq[t]
                self.actions[i] = ep.actions[t]
                self.rewards[i] = ep.rewards[t]
                self.next_obs[i] = obs_seq[t + 1]
                self.dones[i] = done
                self._i = (i + 1) % self.capacity
                self.size = min(self.size + 1, self.capacity)
                n += 1
        return n

    def sample(self, batch_size: int, rng) -> dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, batch_size)
        return {"obs": self.obs[idx], "actions": self.actions[idx],
                "rewards": self.rewards[idx],
                "next_obs": self.next_obs[idx],
                "dones": self.dones[idx]}


class Temperature(nn.Module):
    """SAC's ``log_alpha``, a parameter of its own optimizer."""

    def __init__(self, init_alpha: float, dtype=torch.float32):
        super().__init__()
        self.log_alpha = nn.Parameter(
            torch.log(torch.tensor(init_alpha, dtype=dtype)))


def _grads(loss, module: nn.Module) -> list[torch.Tensor]:
    """d loss / d each parameter of ``module`` (and of nothing else)."""
    return list(torch.autograd.grad(loss, list(module.parameters())))


class ContinuousLearner:
    """What SAC's and CQL's learners share: the actor, the twin critic,
    its polyak target and the temperature, three Adams (one each; the
    target has none), the noise generator, and one captured step over
    all of them (``self._step``, a ``make_step`` of ``self._body``)."""

    hp: Any

    def __init__(self, policy_config: dict, hp, seed: int = 0,
                 device=None):
        self.hp = hp
        self.device = resolve_device(device)
        cfg = ContinuousConfig(**policy_config)
        self.action_dim = cfg.action_dim
        actor = SquashedGaussianActor(cfg, self.device, seed)
        critic = TwinQ(cfg, self.device, seed + 1)
        target = copy.deepcopy(critic).requires_grad_(False)
        modules = nn.ModuleDict({
            "actor": actor, "critic": critic, "target": target,
            "alpha": Temperature(hp.init_alpha, cfg.dtype).to(self.device)})
        self.target_entropy = -float(cfg.action_dim)
        self.actor_opt = adamw(hp.actor_lr, weight_decay=0.0)
        self.critic_opt = adamw(hp.critic_lr, weight_decay=0.0)
        self.alpha_opt = adamw(hp.alpha_lr, weight_decay=0.0)
        self.state = TrainState(step=0, params=modules, opt_state={
            "actor": self.actor_opt.init(actor),
            "critic": self.critic_opt.init(critic),
            "alpha": self.alpha_opt.init(modules["alpha"])})
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self._step = make_step(self._body)

    # -- state --

    @property
    def actor(self) -> SquashedGaussianActor:
        return self.state.params["actor"]

    @property
    def critic(self) -> TwinQ:
        return self.state.params["critic"]

    @property
    def target_critic(self) -> TwinQ:
        return self.state.params["target"]

    @property
    def log_alpha(self) -> torch.Tensor:
        return self.state.params["alpha"].log_alpha

    @property
    def actor_params(self) -> dict[str, torch.Tensor]:
        return dict(self.actor.named_parameters())

    @property
    def compile_count(self) -> int | None:
        """Captures of the step (one per batch shape and flag); None where
        it has only run eagerly (on the CPU)."""
        return compile_count(self._step)

    def load_jax_params(self, actor: dict, critic: dict, target: dict,
                        log_alpha) -> None:
        """Copy the JAX learner's actor, critic and target flax trees and
        its ``log_alpha`` into the modules."""
        load_flax_tree(self.actor, actor)
        load_flax_tree(self.critic, critic)
        load_flax_tree(self.target_critic, target)
        with torch.no_grad():
            self.log_alpha.copy_(torch.from_numpy(np.array(log_alpha)))

    def get_weights(self) -> dict[str, torch.Tensor]:
        """The actor's parameters by name as CPU tensors (what the
        gaussian runners load)."""
        return {k: p.detach().to("cpu", copy=True)
                for k, p in self.actor_params.items()}

    def set_weights(self, weights) -> None:
        load_weights(self.actor, weights)

    # -- the step's pieces --

    def _soft_target(self, m, batch, alpha) -> torch.Tensor:
        """The clipped double-Q soft Bellman target, without gradient."""
        hp = self.hp
        with torch.no_grad():
            mu_n, lstd_n = m["actor"](batch["next_obs"])
            a_next, logp_next = SquashedGaussianActor.sample(
                mu_n, lstd_n, noise=batch["noise_next"])
            q1_t, q2_t = m["target"](batch["next_obs"], a_next)
            q_target = torch.minimum(q1_t, q2_t) - alpha * logp_next
            return batch["rewards"] + hp.gamma * (1 - batch["dones"]) * \
                q_target

    def _actor_step(self, m, opt_state, batch, alpha):
        """SAC's actor objective against ``m["critic"]`` as it is now, and
        the actor's update; returns the loss and the mean log-prob."""
        mu, lstd = m["actor"](batch["obs"])
        a, logp = SquashedGaussianActor.sample(mu, lstd,
                                               noise=batch["noise"])
        q1, q2 = m["critic"](batch["obs"], a)
        a_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
        self.actor_opt.update(_grads(a_loss, m["actor"]), opt_state["actor"],
                              m["actor"])
        return a_loss.detach(), logp.mean().detach()

    def _alpha_step(self, m, opt_state, mean_logp) -> None:
        """The temperature toward the target entropy."""
        la = m["alpha"].log_alpha
        loss = -(torch.exp(la) * (mean_logp + self.target_entropy))
        self.alpha_opt.update(_grads(loss, m["alpha"]), opt_state["alpha"],
                              m["alpha"])

    def _polyak(self, m) -> None:
        tau = self.hp.tau
        with torch.no_grad():
            for t, o in zip(m["target"].parameters(),
                            m["critic"].parameters()):
                t.copy_((1 - tau) * t + tau * o)

    # -- public --

    def draw_noise(self, batch_size: int) -> dict[str, torch.Tensor]:
        """The step's noise for a minibatch of ``batch_size``."""
        shape = (batch_size, self.action_dim)
        return {k: torch.randn(shape, generator=self.generator,
                               device=self.device)
                for k in ("noise_next", "noise")}

    def _run(self, batch: dict[str, np.ndarray], noise, **flags) -> dict:
        mb = batch_to_device({k: np.asarray(v, np.float32)
                              for k, v in batch.items()}, self.device)
        if noise is None:
            noise = self.draw_noise(len(batch["obs"]))
        mb.update({k: as_tensor(v).to(self.device)
                   for k, v in noise.items()}, **flags)
        with full_float32():
            self.state, metrics = self._step(self.state, mb)
        return {k: float(v) for k, v in metrics.items()}


class SACLearner(ContinuousLearner):
    def _body(self, state, batch) -> dict:
        m, opt_state = state.params, state.opt_state
        alpha = torch.exp(m["alpha"].log_alpha.detach())
        y = self._soft_target(m, batch, alpha)
        c_loss = self._critic_step(m, opt_state, batch, y)
        # The actor reads the critic as its update just left it.
        a_loss, mean_logp = self._actor_step(m, opt_state, batch, alpha)
        self._alpha_step(m, opt_state, mean_logp)
        self._polyak(m)
        return {"critic_loss": c_loss, "actor_loss": a_loss,
                "alpha": torch.exp(m["alpha"].log_alpha.detach()),
                "entropy": -mean_logp}

    def _critic_step(self, m, opt_state, batch, y) -> torch.Tensor:
        q1, q2 = m["critic"](batch["obs"], batch["actions"])
        loss = ((q1 - y) ** 2 + (q2 - y) ** 2).mean()
        self.critic_opt.update(_grads(loss, m["critic"]),
                               opt_state["critic"], m["critic"])
        return loss.detach()

    def update(self, batch: dict[str, np.ndarray], noise=None) -> dict:
        """One step on a minibatch; ``noise`` ({"noise_next", "noise"},
        each [B, A] standard normal) drawn here unless given."""
        return self._run(batch, noise)


@dataclass
class SACConfig(LearnersConfig):
    env: Any = None
    policy_config: dict = field(default_factory=dict)
    num_env_runners: int = 2
    rollout_fragment_length: int = 64
    hparams: SACHyperparams = field(default_factory=SACHyperparams)
    seed: int = 0
    device: Any = None                      # the learner's; None: the card

    def environment(self, env, *, obs_dim: int, action_dim: int,
                    hidden: tuple = (64, 64)) -> "SACConfig":
        return replace(self, env=env, policy_config={
            "obs_dim": obs_dim, "action_dim": action_dim,
            "hidden": hidden})

    def env_runners(self, num_env_runners: int) -> "SACConfig":
        return replace(self, num_env_runners=num_env_runners)

    def training(self, **hp_overrides) -> "SACConfig":
        return replace(self, hparams=replace(self.hparams,
                                             **hp_overrides))

    def build(self) -> "SAC":
        return SAC(self)


class SAC(SupportsEvaluation):
    def __init__(self, config: SACConfig):
        assert config.env is not None
        self.config = config
        hp = config.hparams
        self.learner = SACLearner(config.policy_config, hp,
                                  seed=config.seed, device=config.device)
        self.runners = EnvRunnerGroup(
            config.env, config.policy_config,
            num_runners=config.num_env_runners, seed=config.seed,
            policy="gaussian")
        self.buffer = ContinuousReplayBuffer(
            hp.buffer_size, config.policy_config["obs_dim"],
            config.policy_config["action_dim"])
        self.rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self.runners.set_weights(self.learner.get_weights())

    def train(self) -> dict:
        hp = self.config.hparams
        t0 = time.time()
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
            "time_sample_s": round(sample_time, 3),
            "time_learn_s": round(learn_time, 3),
            **metrics,
        }

    def stop(self) -> None:
        self.runners.shutdown()
