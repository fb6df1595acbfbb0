"""CQL — conservative Q-learning for offline continuous control, on the
port.

Counterpart of ``ray_tpu/rllib/cql.py``. Reference analog:
rllib/algorithms/cql/ — SAC trained purely from a logged transition
dataset, with a conservative penalty that pushes down Q-values on
out-of-distribution actions:

    penalty = logsumexp_a Q(s, a) - Q(s, a_data)

estimated over a mixture of uniform-random and current-policy action
samples with importance correction (CQL(H), Kumar et al. 2020). The
actor, the twin critic (Bellman + penalty) and the temperature updates
of one minibatch are ONE step (``train.step.make_step``: one CUDA graph
on the card), SAC's machinery (``sac.ContinuousLearner``). The BC warm-up
of the actor is a flag of the step, as it is a static argument of the
JAX step: each value is captured once.

The step's noise is an input: the next-state sample's, the uniform
penalty actions in [-1, 1), the policy's penalty samples and the actor's
sample, drawn by the learner from its own ``torch.Generator`` (seeded
``seed + 1``), or given (``update(batch, noise=...)``). The learner runs
on the card unless the config asks otherwise (``.learners(device=
"cpu")``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import LearnersConfig
from ray_tpu_torch.rllib.models import SquashedGaussianActor
from ray_tpu_torch.rllib.sac import ContinuousLearner, _grads


@dataclass
class CQLHyperparams:
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    init_alpha: float = 0.1
    min_q_weight: float = 5.0       # conservative penalty scale
    num_penalty_actions: int = 10   # samples per (random, policy) set
    train_batch_size: int = 256
    num_gradient_steps: int = 16
    bc_warmup_steps: int = 0        # actor BC steps before SAC loss


class CQLLearner(ContinuousLearner):
    def __init__(self, policy_config: dict, hp: CQLHyperparams,
                 seed: int = 0, device=None):
        super().__init__(policy_config, hp, seed, device)
        self.steps = 0

    # -- penalty helper: Q over N sampled actions per state ----------

    def _q_samples(self, critic, obs, actions):
        """Q1/Q2 for (B, N, A) actions -> (B, N) each. Each state is
        repeated N times in a row (``jnp.repeat``, not ``Tensor.repeat``,
        which would tile the batch)."""
        B, N, A = actions.shape
        q1, q2 = critic(torch.repeat_interleave(obs, N, 0),
                        actions.reshape(B * N, A))
        return q1.reshape(B, N), q2.reshape(B, N)

    def _body(self, state, batch) -> dict:
        hp = self.hp
        m, opt_state = state.params, state.opt_state
        alpha = torch.exp(m["alpha"].log_alpha.detach())
        B, N, A = batch["obs"].shape[0], hp.num_penalty_actions, \
            self.action_dim
        y = self._soft_target(m, batch, alpha)

        # Penalty action sets (sampled outside the loss; the penalty
        # differentiates through Q only, like the reference).
        with torch.no_grad():
            mu_c, lstd_c = m["actor"](batch["obs"])
            a_pi, logp_pi = SquashedGaussianActor.sample(
                torch.repeat_interleave(mu_c, N, 0),
                torch.repeat_interleave(lstd_c, N, 0),
                noise=batch["noise_pi"])
            a_pi = a_pi.reshape(B, N, A)
            logp_pi = logp_pi.reshape(B, N)
        # log density of uniform over [-1,1]^A for the IS correction
        log_unif = -A * math.log(2.0)
        log_2n = math.log(2 * N)

        critic = m["critic"]
        q1, q2 = critic(batch["obs"], batch["actions"])
        bellman = ((q1 - y) ** 2 + (q2 - y) ** 2).mean()
        q1_r, q2_r = self._q_samples(critic, batch["obs"], batch["a_rand"])
        q1_p, q2_p = self._q_samples(critic, batch["obs"], a_pi)
        # CQL(H): importance-corrected logsumexp over the mixture.
        lse1 = torch.logsumexp(torch.cat(
            [q1_r - log_unif, q1_p - logp_pi], 1), 1) - log_2n
        lse2 = torch.logsumexp(torch.cat(
            [q2_r - log_unif, q2_p - logp_pi], 1), 1) - log_2n
        penalty = ((lse1 - q1) + (lse2 - q2)).mean()
        c_loss = bellman + hp.min_q_weight * penalty
        self.critic_opt.update(_grads(c_loss, critic), opt_state["critic"],
                               critic)

        # -- actor: SAC objective, or BC warmup toward data actions --
        if batch["bc"]:
            mu, lstd = m["actor"](batch["obs"])
            _a, logp = SquashedGaussianActor.sample(mu, lstd,
                                                    noise=batch["noise"])
            bc_err = ((torch.tanh(mu) - batch["actions"]) ** 2) \
                .sum(-1).mean()
            a_loss, mean_logp = (alpha * logp).mean() + bc_err, logp.mean()
            self.actor_opt.update(_grads(a_loss, m["actor"]),
                                  opt_state["actor"], m["actor"])
            a_loss, mean_logp = a_loss.detach(), mean_logp.detach()
        else:
            a_loss, mean_logp = self._actor_step(m, opt_state, batch, alpha)
        self._alpha_step(m, opt_state, mean_logp)
        self._polyak(m)
        return {"critic_loss": c_loss.detach(),
                "bellman_loss": bellman.detach(),
                "cql_penalty": penalty.detach(), "actor_loss": a_loss,
                "alpha": torch.exp(m["alpha"].log_alpha.detach())}

    def draw_noise(self, batch_size: int) -> dict[str, torch.Tensor]:
        """The step's noise for a minibatch of ``batch_size``: SAC's two
        normal draws, the uniform penalty actions in [-1, 1) and the
        policy's penalty samples' normal draws."""
        B, N, A = batch_size, self.hp.num_penalty_actions, self.action_dim
        out = super().draw_noise(B)
        out["a_rand"] = torch.rand((B, N, A), generator=self.generator,
                                   device=self.device) * 2.0 - 1.0
        out["noise_pi"] = torch.randn((B * N, A), generator=self.generator,
                                      device=self.device)
        return out

    def update(self, batch: dict[str, np.ndarray], noise=None) -> dict:
        """One step on a minibatch; ``noise`` (:meth:`draw_noise`'s keys)
        drawn here unless given."""
        bc = self.steps < self.hp.bc_warmup_steps
        self.steps += 1
        return self._run(batch, noise, bc=bc)


@dataclass
class CQLConfig(LearnersConfig):
    dataset: Any = None
    policy_config: dict = field(default_factory=dict)
    hparams: CQLHyperparams = field(default_factory=CQLHyperparams)
    seed: int = 0
    device: Any = None                      # the learner's; None: the card

    def environment(self, *, obs_dim: int, action_dim: int,
                    hidden: tuple = (64, 64)) -> "CQLConfig":
        return replace(self, policy_config={
            "obs_dim": obs_dim, "action_dim": action_dim,
            "hidden": hidden})

    def offline_data(self, dataset) -> "CQLConfig":
        """Dataset columns: obs, action (float rows), reward,
        next_obs, done — logged transitions."""
        return replace(self, dataset=dataset)

    def training(self, **hp_overrides) -> "CQLConfig":
        return replace(self, hparams=replace(self.hparams,
                                             **hp_overrides))

    def build(self) -> "CQL":
        return CQL(self)


class CQL:
    def __init__(self, config: CQLConfig):
        assert config.dataset is not None, "call .offline_data(ds)"
        assert config.policy_config, "call .environment(...)"
        self.config = config
        self.learner = CQLLearner(config.policy_config,
                                  config.hparams, seed=config.seed,
                                  device=config.device)
        self.rng = np.random.default_rng(config.seed)
        self.iteration = 0
        batches = list(config.dataset.iter_batches())

        def col(name, dtype=np.float32):
            return np.concatenate(
                [np.asarray(b[name], dtype) for b in batches])

        self._data = {
            "obs": col("obs"), "actions": col("action"),
            "rewards": col("reward"), "next_obs": col("next_obs"),
            "dones": col("done"),
        }

    def train(self) -> dict:
        hp = self.config.hparams
        t0 = time.time()
        metrics: dict = {}
        n = len(self._data["obs"])
        for _ in range(hp.num_gradient_steps):
            idx = self.rng.integers(0, n, hp.train_batch_size)
            metrics = self.learner.update(
                {k: v[idx] for k, v in self._data.items()})
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "num_samples": n,
                "time_learn_s": round(time.time() - t0, 3),
                **metrics}

    def stop(self) -> None:
        pass
