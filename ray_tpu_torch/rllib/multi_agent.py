"""Multi-agent RL: shared or per-policy training over a MultiAgentEnv.

Reference analog: rllib/env/multi_agent_env.py + the multi-agent new
API stack — envs step a DICT of agents; a ``policy_mapping_fn`` maps
agent ids to policy ids; each policy trains on the episodes its
agents produced (independent PPO, the reference's default
multi-agent treatment).

MultiAgentEnv protocol (gymnasium-style dict spaces):
    reset(seed) -> (obs: {agent: obs}, info)
    step(actions: {agent: act})
        -> (obs, rewards, terminateds, truncateds, info)
  ``terminateds["__all__"]`` ends the episode for everyone.

Counterpart of ``ray_tpu/rllib/multi_agent.py``: one ``TorchLearner`` per
policy (on the config's ``device``: the card by default, ``"cpu"`` when
asked), as the JAX module has one ``JaxLearner`` per policy; the runners
keep CPU copies of every policy and run torch on one thread.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import Episode
from ray_tpu_torch.rllib.learner import PPOHyperparams, TorchLearner


class MultiAgentEnv:
    """Subclassable base for the protocol above (reference:
    rllib/env/multi_agent_env.py). Duck-typed envs work too — the
    runners only need reset/step with dict agents; this base exists
    so reference-style ``class MyEnv(MultiAgentEnv)`` code ports
    unchanged and gets the contract documented in one place."""

    def __init__(self):
        # per-INSTANCE list: a class-level [] default would be shared
        # mutable state across every env instance and subclass
        self.possible_agents: list = list(
            getattr(type(self), "possible_agents", []))

    def reset(self, *, seed=None, options=None):
        raise NotImplementedError

    def step(self, actions: dict):
        raise NotImplementedError


@ray_tpu_torch.remote
class MultiAgentEnvRunner:
    """Steps one MultiAgentEnv; keeps a host copy of every policy."""

    def __init__(self, env_maker, policy_configs: dict[str, dict],
                 policy_mapping: Callable[[str], str], seed: int = 0):
        import torch

        from ray_tpu_torch.rllib.catalog import build_actor_critic

        torch.set_num_threads(1)
        self.env = env_maker()
        self.mapping = policy_mapping
        self.rng = np.random.default_rng(seed)
        self.models = {
            pid: build_actor_critic(cfg, "cpu", seed + i)
            for i, (pid, cfg) in enumerate(policy_configs.items())}
        self._obs, _ = self.env.reset(seed=seed)

    def _fwd(self, pid: str, obs: np.ndarray):
        import torch

        with torch.inference_mode():
            return self.models[pid](torch.from_numpy(obs))

    def set_weights(self, params_by_policy: dict) -> bool:
        """Load each policy's weights (CPU tensors by name) in place."""
        from ray_tpu_torch.rllib.learner import load_weights
        for pid, weights in params_by_policy.items():
            load_weights(self.models[pid], weights)
        return True

    def sample(self, num_steps: int) -> dict[str, list]:
        """~num_steps env steps; returns {policy_id: [Episode, ...]}
        (per-agent trajectories grouped by the policy that acted)."""
        import torch

        episodes: dict[str, list[Episode]] = {}
        open_eps: dict[str, Episode] = {}       # agent -> episode

        def close(agent, terminated, bootstrap_obs, mark_done=True):
            """End an agent's trajectory. mark_done=False = fragment
            boundary: episode stays terminated=truncated=False (the
            single-agent convention — excluded from reward metrics)
            but still bootstraps from ``bootstrap_obs``."""
            ep = open_eps.pop(agent, None)
            if ep is None or not ep.length:
                return
            if mark_done:
                ep.terminated = terminated
                ep.truncated = not terminated
            if terminated:
                ep.last_value = 0.0
            else:
                pid = self.mapping(agent)
                if bootstrap_obs is None:
                    bootstrap_obs = ep.obs[-1]
                _, v = self._fwd(
                    pid, np.asarray(bootstrap_obs, np.float32)[None])
                ep.last_value = float(v[0])
            episodes.setdefault(self.mapping(agent), []).append(ep)

        for _ in range(num_steps):
            actions = {}
            step_info = {}
            for agent, obs in self._obs.items():
                pid = self.mapping(agent)
                logits, value = self._fwd(
                    pid, np.asarray(obs, np.float32)[None])
                probs = torch.softmax(logits[0], -1).numpy()
                action = int(self.rng.choice(len(probs), p=probs))
                actions[agent] = action
                step_info[agent] = (
                    np.asarray(obs, np.float32), action,
                    float(np.log(probs[action] + 1e-9)),
                    float(value[0]))
            next_obs, rewards, terms, truncs, _ = self.env.step(actions)
            for agent, (obs, action, logp, value) in step_info.items():
                ep = open_eps.setdefault(agent, Episode())
                ep.obs.append(obs)
                ep.actions.append(action)
                ep.rewards.append(float(rewards.get(agent, 0.0)))
                ep.logps.append(logp)
                ep.values.append(value)
            done_all = terms.get("__all__", False) or \
                truncs.get("__all__", False)
            if done_all:
                for agent in list(open_eps):
                    close(agent,
                          terms.get(agent, terms.get("__all__", False)),
                          next_obs.get(agent))
                self._obs, _ = self.env.reset()
                continue
            # Per-agent termination without __all__: close THAT
            # agent's trajectory now and stop stepping it (the env
            # drops it from obs, or we drop it here).
            self._obs = dict(next_obs)
            for agent in list(open_eps):
                if terms.get(agent, False) or truncs.get(agent, False):
                    close(agent, terms.get(agent, False),
                          next_obs.get(agent))
                    self._obs.pop(agent, None)
            if not self._obs:      # everyone ended individually
                self._obs, _ = self.env.reset()
        for agent in list(open_eps):
            close(agent, False, self._obs.get(agent), mark_done=False)
        return episodes

    def ping(self) -> str:
        return "ok"


@dataclass
class MultiAgentPPOConfig:
    env: Any = None
    policies: dict[str, dict] = field(default_factory=dict)
    policy_mapping_fn: Callable[[str], str] | None = None
    num_env_runners: int = 2
    rollout_fragment_length: int = 128
    hparams: PPOHyperparams = field(default_factory=PPOHyperparams)
    seed: int = 0
    device: Any = None                      # the learners'; None: the card

    def environment(self, env) -> "MultiAgentPPOConfig":
        return replace(self, env=env)

    def multi_agent(self, *, policies: dict[str, dict],
                    policy_mapping_fn: Callable[[str], str]
                    ) -> "MultiAgentPPOConfig":
        """policies: {policy_id: {obs_dim, num_actions, hidden}}."""
        return replace(self, policies=dict(policies),
                       policy_mapping_fn=policy_mapping_fn)

    def env_runners(self, n: int) -> "MultiAgentPPOConfig":
        return replace(self, num_env_runners=n)

    def learners(self, *, device=None) -> "MultiAgentPPOConfig":
        """The learners' device: ``"cpu"``, or a card; None is
        ``cuda:0``."""
        return replace(self, device=device)

    def training(self, **hp) -> "MultiAgentPPOConfig":
        return replace(self, hparams=replace(self.hparams, **hp))

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """Independent PPO per policy: each policy id owns a TorchLearner
    updated from its agents' episodes."""

    def __init__(self, config: MultiAgentPPOConfig):
        assert config.env is not None and config.policies
        assert config.policy_mapping_fn is not None
        self.config = config
        self.learners = {
            pid: TorchLearner(cfg, config.hparams,
                              seed=config.seed + i, device=config.device)
            for i, (pid, cfg) in enumerate(config.policies.items())}
        self.runners = [
            MultiAgentEnvRunner.remote(
                config.env, config.policies,
                config.policy_mapping_fn, config.seed + i)
            for i in range(config.num_env_runners)]
        self.iteration = 0
        self._broadcast()

    def _broadcast(self) -> None:
        weights = {pid: ln.get_weights()
                   for pid, ln in self.learners.items()}
        ref = ray_tpu_torch.put(weights)
        ray_tpu_torch.get([r.set_weights.remote(ref) for r in self.runners],
                    timeout=300)

    def train(self) -> dict:
        t0 = time.time()
        per = max(1, self.config.rollout_fragment_length)
        results = ray_tpu_torch.get(
            [r.sample.remote(per) for r in self.runners], timeout=600)
        by_policy: dict[str, list[Episode]] = {}
        for r in results:
            for pid, eps in r.items():
                by_policy.setdefault(pid, []).extend(eps)
        sample_time = time.time() - t0

        metrics: dict[str, Any] = {}
        t1 = time.time()
        for pid, eps in by_policy.items():
            if eps:
                m = self.learners[pid].update_from_episodes(eps)
                metrics.update({f"{pid}/{k}": v for k, v in m.items()})
        self._broadcast()
        self.iteration += 1

        finished = [e for eps in by_policy.values() for e in eps
                    if e.terminated or e.truncated]
        mean_r = (sum(e.total_reward for e in finished) / len(finished)
                  if finished else float("nan"))
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": mean_r,
            "episodes_this_iter": len(finished),
            "time_sample_s": round(sample_time, 3),
            "time_learn_s": round(time.time() - t1, 3),
            **metrics,
        }

    def stop(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass
