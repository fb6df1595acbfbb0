"""MARWIL — monotonic advantage re-weighted imitation learning, on the port.

Counterpart of ``ray_tpu/rllib/marwil.py``. Reference analog:
rllib/algorithms/marwil/ — offline RL between BC and full policy
gradient: a value head estimates advantages A = R - V(s) from logged
returns, and the imitation loss weights each (obs, action) pair by
exp(beta * A / c), where c is a running norm of the advantage magnitude
(RLlib's moving_average_sqd_adv_norm). With beta=0 it is exactly BC. The
whole update (value loss, re-weighted NLL, the norm's running average) is
one step of ``train.step.make_train_step``, captured on the card as one
CUDA graph; the running ``adv_sq_norm`` is the step's ``extra``, written
in place by the step. The learner runs on the card unless the config asks
otherwise (``.learners(device="cpu")``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.rllib.algorithm import LearnersConfig
from ray_tpu_torch.rllib.catalog import build_actor_critic
from ray_tpu_torch.rllib.learner import (
    ModelLearner, batch_to_device, full_float32,
)
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.train.step import init_train_state, make_train_step


@dataclass
class MARWILHyperparams:
    lr: float = 1e-3
    beta: float = 1.0               # 0 => plain BC
    vf_coeff: float = 1.0
    exp_adv_clip: float = 20.0      # cap on the exp weights
    norm_ema: float = 1e-2          # advantage-norm update rate
    train_batch_size: int = 256
    num_gradient_steps: int = 16


def returns_from_rewards(rewards, dones, gamma: float = 0.99):
    """Discounted return-to-go per step from flat (reward, done)
    transition logs — convenience for datasets that carry rewards
    instead of precomputed returns."""
    out = np.zeros(len(rewards), np.float32)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        if dones[t]:
            acc = 0.0
        acc = rewards[t] + gamma * acc
        out[t] = acc
    return out


class MARWILLearner(ModelLearner):
    def __init__(self, policy_config: dict, hp: MARWILHyperparams,
                 seed: int = 0, device=None):
        self.hp = hp
        self.device = resolve_device(device)
        self.model = build_actor_critic(policy_config, self.device, seed)
        self.opt = adamw(hp.lr, weight_decay=0.0)
        # Running E[A^2] estimate (c^2); starts at 1 like RLlib.
        self.state = init_train_state(
            self.model, self.opt,
            extra={"adv_sq_norm": torch.ones((), device=self.device)})
        self._update = make_train_step(self._loss, self.opt, has_extra=True,
                                       grad_norm=False, has_aux=True)

    @property
    def adv_sq_norm(self) -> torch.Tensor:
        return self.state.extra["adv_sq_norm"]

    def _loss(self, model, extra, batch):
        hp = self.hp
        logits, values = model(batch["obs"])
        adv = batch["return"] - values
        vf_loss = (adv ** 2).mean()
        norm = extra["adv_sq_norm"]
        c = torch.sqrt(norm) + 1e-8
        weights = torch.clamp(torch.exp(hp.beta * adv.detach() / c),
                              max=hp.exp_adv_clip)
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, batch["action"].long()[:, None])[:, 0]
        pi_loss = (weights * nll).mean()
        total = pi_loss + hp.vf_coeff * vf_loss
        with torch.no_grad():
            new_norm = norm + hp.norm_ema * ((adv ** 2).mean() - norm)
        return total, {"adv_sq_norm": new_norm}, {
            "policy_loss": pi_loss.detach(), "vf_loss": vf_loss.detach(),
            "mean_weight": weights.mean()}

    def update(self, batch: dict[str, np.ndarray]) -> dict:
        mb = batch_to_device(
            {"obs": np.asarray(batch["obs"], np.float32),
             "action": np.asarray(batch["action"], np.int64),
             "return": np.asarray(batch["return"], np.float32)},
            self.device)
        with full_float32():
            self.state, metrics = self._update(self.state, mb)
        return {"total_loss": float(metrics["loss"]),
                **{k: float(metrics[k]) for k in (
                    "policy_loss", "vf_loss", "mean_weight")}}


@dataclass
class MARWILConfig(LearnersConfig):
    dataset: Any = None
    policy_config: dict = field(default_factory=dict)
    hparams: MARWILHyperparams = field(
        default_factory=MARWILHyperparams)
    gamma: float = 0.99
    seed: int = 0
    device: Any = None                      # the learner's; None: the card

    def environment(self, *, obs_dim: int, num_actions: int,
                    hidden: tuple = (64, 64)) -> "MARWILConfig":
        return replace(self, policy_config={
            "obs_dim": obs_dim, "num_actions": num_actions,
            "hidden": hidden})

    def offline_data(self, dataset) -> "MARWILConfig":
        """Dataset columns: "obs" (float rows), "action" (int), and
        either "return" (float return-to-go) or "reward" + "done"
        (returns are derived with ``returns_from_rewards``)."""
        return replace(self, dataset=dataset)

    def training(self, *, gamma: float | None = None,
                 **hp_overrides) -> "MARWILConfig":
        return replace(
            self, gamma=self.gamma if gamma is None else gamma,
            hparams=replace(self.hparams, **hp_overrides))

    def build(self) -> "MARWIL":
        return MARWIL(self)


class MARWIL:
    def __init__(self, config: MARWILConfig):
        assert config.dataset is not None, "call .offline_data(ds)"
        assert config.policy_config, "call .environment(...)"
        self.config = config
        self.learner = MARWILLearner(
            config.policy_config, config.hparams, seed=config.seed,
            device=config.device)
        self.rng = np.random.default_rng(config.seed)
        self.iteration = 0
        batches = list(config.dataset.iter_batches())
        self._obs = np.concatenate(
            [np.asarray(b["obs"], np.float32) for b in batches])
        self._act = np.concatenate(
            [np.asarray(b["action"], np.int64) for b in batches])
        if all("return" in b for b in batches):
            self._ret = np.concatenate(
                [np.asarray(b["return"], np.float32)
                 for b in batches])
        else:
            rewards = np.concatenate(
                [np.asarray(b["reward"], np.float32)
                 for b in batches])
            dones = np.concatenate(
                [np.asarray(b["done"]) for b in batches])
            self._ret = returns_from_rewards(rewards, dones,
                                             config.gamma)

    def train(self) -> dict:
        hp = self.config.hparams
        t0 = time.time()
        metrics: dict = {}
        n = len(self._obs)
        for _ in range(hp.num_gradient_steps):
            idx = self.rng.integers(0, n, hp.train_batch_size)
            metrics = self.learner.update({
                "obs": self._obs[idx], "action": self._act[idx],
                "return": self._ret[idx]})
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "num_samples": n,
                "time_learn_s": round(time.time() - t0, 3),
                **metrics}

    def stop(self) -> None:
        pass
