"""IMPALA: importance-weighted actor-learner with V-trace, on the port.

Counterpart of ``ray_tpu/rllib/impala.py``. Reference analog:
rllib/algorithms/impala/ — env runners sample with a (possibly stale)
behavior policy; the learner corrects the off-policyness with V-trace
(Espeholt et al. 2018) truncated importance sampling. Episodes are padded
to a fixed [B, T] block, and the whole update — forward, the V-trace
recursion, the loss, backward, ``clip_by_global_norm`` and RMSProp (or
Adam) — is one step of ``train.step.make_train_step``, captured on the
card as one CUDA graph. The JAX learner's reverse ``lax.scan`` over T is a
reverse loop over T inside the step. B is the number of episodes in an
iteration, so a new B is a new batch shape and captures again, as
``jit`` retraces (``compile_count`` counts them). Weight broadcast every
``broadcast_interval`` iterations reproduces the actor lag the algorithm
is built to absorb.

The learner runs on the card unless the config asks otherwise
(``.learners(device="cpu")``); the runners stay on the CPU.
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
from ray_tpu_torch.rllib.env_runner import (
    EnvRunnerGroup, SupportsEvaluation,
)
from ray_tpu_torch.rllib.learner import (
    ModelLearner, batch_to_device, full_float32,
)
from ray_tpu_torch.train.optim import (
    adamw, chain, clip_by_global_norm, rmsprop,
)
from ray_tpu_torch.train.step import init_train_state, make_train_step


@dataclass
class ImpalaHyperparams:
    lr: float = 5e-4
    gamma: float = 0.99
    rho_bar: float = 1.0            # v-trace rho clip
    c_bar: float = 1.0              # v-trace c clip
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    max_grad_norm: float = 40.0
    broadcast_interval: int = 1     # iterations between weight syncs
    # "rmsprop" (the IMPALA-paper setting, tuned for large batches)
    # or "adam" (better conditioned for small batches).
    optimizer: str = "rmsprop"
    rmsprop_eps: float = 0.1


def vtrace(values, rewards, discounts, rho_c, c, mask, last_step,
           bootstrap) -> tuple[torch.Tensor, torch.Tensor]:
    """V-trace targets ``vs`` and advantages ``r + γ·vs(t+1) − V`` over a
    ``[B, T]`` block, computed without gradient (both enter the losses
    only as constants). V(final_obs) is injected at each episode's LAST
    REAL step (``last_step``): episodes shorter than T must not bootstrap
    from zero-padded observations. The mask kills padded steps' deltas
    before the reverse recursion."""
    with torch.no_grad():
        B, T = values.shape
        values, rho_c, c = values.detach(), rho_c.detach(), c.detach()
        last = (torch.arange(T, device=values.device)[None, :]
                == last_step[:, None].long())
        zero = torch.zeros((B, 1), dtype=values.dtype, device=values.device)
        v_tp1 = torch.where(last, bootstrap[:, None],
                            torch.cat([values[:, 1:], zero], 1))
        deltas = rho_c * (rewards + discounts * v_tp1 - values) * mask
        acc = torch.zeros_like(values[:, 0])
        steps = [acc] * T
        for t in range(T - 1, -1, -1):
            acc = deltas[:, t] + discounts[:, t] * c[:, t] * acc
            steps[t] = acc
        vs = values + torch.stack(steps, 1)
        vs_tp1 = torch.where(last, bootstrap[:, None],
                             torch.cat([vs[:, 1:], zero], 1))
        adv = rewards + discounts * vs_tp1 - values
    return vs, adv


class ImpalaLearner(ModelLearner):
    def __init__(self, policy_config: dict, hp: ImpalaHyperparams,
                 max_seq_len: int, seed: int = 0, device=None):
        self.hp = hp
        self.T = max_seq_len
        self.device = resolve_device(device)
        self.model = build_actor_critic(policy_config, self.device, seed)
        inner = (adamw(hp.lr, weight_decay=0.0) if hp.optimizer == "adam"
                 else rmsprop(hp.lr, decay=0.99, eps=hp.rmsprop_eps))
        self.opt = chain(clip_by_global_norm(hp.max_grad_norm), inner)
        self.state = init_train_state(self.model, self.opt)
        self._update = make_train_step(self._loss, self.opt,
                                       grad_norm=False, has_aux=True)

    def _vtrace_terms(self, model, batch) -> dict:
        """Shared V-trace machinery (forward pass, V-trace targets,
        advantages, the value and entropy terms) — used by both the
        IMPALA loss and APPO's clipped-surrogate loss."""
        hp = self.hp
        B, T = batch["actions"].shape
        logits, values = model(batch["obs"].reshape(B * T, -1))
        logits = logits.reshape(B, T, -1)
        values = values.reshape(B, T)
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["actions"].long()[..., None])[..., 0]
        rho = torch.exp(logp - batch["behavior_logp"])
        rho_c = torch.clamp(rho, max=hp.rho_bar)
        c = torch.clamp(rho, max=hp.c_bar)
        mask = batch["mask"]
        discounts = hp.gamma * (1.0 - batch["dones"]) * mask
        vs, adv = vtrace(values, batch["rewards"], discounts, rho_c, c, mask,
                         batch["last_step"], batch["bootstrap"])
        denom = torch.clamp(mask.sum(), min=1.0)
        ent = -(torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
                * mask).sum() / denom
        vf_loss = (((values - vs) ** 2) * mask).sum() / denom
        return {"logp": logp, "rho": rho, "rho_c": rho_c, "vs": vs,
                "adv": adv, "mask": mask, "denom": denom, "entropy": ent,
                "vf_loss": vf_loss}

    def _policy_loss(self, t: dict):
        """IMPALA: importance-weighted policy gradient. rho_c is a WEIGHT
        here, not part of the objective (detached); APPO's surrogate
        differentiates through the ratio on purpose."""
        return -(t["logp"] * t["rho_c"].detach() * t["adv"]
                 * t["mask"]).sum() / t["denom"]

    def _loss(self, model, batch):
        hp = self.hp
        t = self._vtrace_terms(model, batch)
        pi_loss = self._policy_loss(t)
        total = (pi_loss + hp.vf_coeff * t["vf_loss"]
                 - hp.entropy_coeff * t["entropy"])
        mean_rho = (t["rho"] * t["mask"]).sum() / t["denom"]
        return total, {"policy_loss": pi_loss, "vf_loss": t["vf_loss"],
                       "entropy": t["entropy"], "mean_rho": mean_rho}

    def _pad_episodes(self, episodes) -> dict[str, np.ndarray]:
        T = self.T
        obs_dim = len(episodes[0].obs[0])
        B = len(episodes)
        batch = {
            "obs": np.zeros((B, T, obs_dim), np.float32),
            "actions": np.zeros((B, T), np.int32),
            "rewards": np.zeros((B, T), np.float32),
            "behavior_logp": np.zeros((B, T), np.float32),
            "dones": np.zeros((B, T), np.float32),
            "mask": np.zeros((B, T), np.float32),
            "bootstrap": np.zeros((B,), np.float32),
            "last_step": np.zeros((B,), np.int32),
        }
        for i, ep in enumerate(episodes):
            n = min(ep.length, T)
            batch["obs"][i, :n] = np.stack(ep.obs[:n])
            batch["actions"][i, :n] = ep.actions[:n]
            batch["rewards"][i, :n] = ep.rewards[:n]
            batch["behavior_logp"][i, :n] = ep.logps[:n]
            batch["mask"][i, :n] = 1.0
            batch["last_step"][i] = n - 1
            if ep.terminated:
                batch["dones"][i, n - 1] = 1.0
            batch["bootstrap"][i] = ep.last_value
        return batch

    def make_batch(self, episodes) -> dict[str, np.ndarray]:
        """The padded [B, T] batch of ``episodes`` with the bootstrap
        values of truncated episodes under the CURRENT parameters."""
        batch = self._pad_episodes(episodes)
        finals = np.stack([
            e.final_obs if e.final_obs is not None else e.obs[-1]
            for e in episodes]).astype(np.float32)
        with torch.no_grad(), full_float32():
            _, boot = self.model(torch.from_numpy(finals).to(self.device))
        term = np.array([e.terminated for e in episodes])
        batch["bootstrap"] = np.where(
            term, 0.0, boot.float().cpu().numpy()).astype(np.float32)
        return batch

    def update(self, batch: dict[str, np.ndarray]) -> dict[str, float]:
        """One update on a padded batch (:meth:`make_batch`)."""
        with full_float32():
            self.state, metrics = self._update(
                self.state, batch_to_device(batch, self.device))
        return {"total_loss": float(metrics["loss"]),
                **{k: float(metrics[k]) for k in (
                    "policy_loss", "vf_loss", "entropy", "mean_rho")}}

    def update_from_episodes(self, episodes) -> dict[str, float]:
        episodes = [e for e in episodes if e.length]
        if not episodes:
            return {}
        return self.update(self.make_batch(episodes))


@dataclass
class ImpalaConfig(LearnersConfig):
    env: Any = None
    policy_config: dict = field(default_factory=dict)
    num_env_runners: int = 2
    rollout_fragment_length: int = 64
    hparams: ImpalaHyperparams = field(
        default_factory=ImpalaHyperparams)
    seed: int = 0
    device: Any = None                      # the learner's; None: the card

    def environment(self, env, *, obs_dim: int, num_actions: int,
                    hidden: tuple = (64, 64)) -> "ImpalaConfig":
        return replace(self, env=env, policy_config={
            "obs_dim": obs_dim, "num_actions": num_actions,
            "hidden": hidden})

    def env_runners(self, num_env_runners: int) -> "ImpalaConfig":
        return replace(self, num_env_runners=num_env_runners)

    def training(self, **hp_overrides) -> "ImpalaConfig":
        return replace(self, hparams=replace(self.hparams,
                                             **hp_overrides))

    def build(self) -> "Impala":
        return Impala(self)


class Impala(SupportsEvaluation):
    learner_cls = ImpalaLearner   # subclasses (APPO) swap the learner

    def __init__(self, config: ImpalaConfig):
        assert config.env is not None
        self.config = config
        self.learner = self.learner_cls(
            config.policy_config, config.hparams,
            max_seq_len=config.rollout_fragment_length,
            seed=config.seed, device=config.device)
        self.runners = EnvRunnerGroup(
            config.env, config.policy_config,
            num_runners=config.num_env_runners, seed=config.seed,
            policy="categorical")
        self.iteration = 0
        self.runners.set_weights(self.learner.get_weights())

    def train(self) -> dict:
        t0 = time.time()
        episodes = self.runners.sample(
            self.config.rollout_fragment_length)
        sample_time = time.time() - t0
        t1 = time.time()
        metrics = self.learner.update_from_episodes(episodes)
        learn_time = time.time() - t1
        self.iteration += 1
        if self.iteration % self.config.hparams.broadcast_interval == 0:
            self.runners.set_weights(self.learner.get_weights())
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

    def stop(self) -> None:
        self.runners.shutdown()
