"""Env runners: actor-hosted environment stepping.

Counterpart of ``ray_tpu/rllib/env_runner.py``. Reference analog:
SingleAgentEnvRunner actors inside an EnvRunnerGroup
(single_agent_env_runner.py:61, env_runner_group.py:71). Runners hold
gymnasium envs and a CPU copy of the policy; sampling is the hot loop
(env.step + policy forward) and stays on host CPU — the card belongs to
the learner. A runner actor asks for no GPU (its process sees
``CUDA_VISIBLE_DEVICES=""``), builds its model with ``device="cpu"``, an
explicit choice, and runs torch on one thread, so that several runners
beside the learner do not each start an OpenMP thread for every core.
The forward is eager, one observation at a time, under
``torch.inference_mode``, as the JAX runner's jitted one.

Categorical and epsilon-greedy actions come from the runner's numpy
``default_rng(seed)``, as in the JAX runner, so they agree whenever the
probabilities do; the gaussian policy draws from a
``torch.Generator(seed)`` where the JAX runner splits
``jax.random.key(seed)``: equal in distribution, not in stream. Weights
arrive as a dict of CPU tensors by name (``TorchLearner.get_weights``).
``policy="dreamer"`` runs Dreamer's rollout step (``dreamer.
build_dreamer_policy``: the module's posterior mode, its carry (h, z,
a_prev), the chosen action fed into the carry after each step).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

import ray_tpu_torch


@dataclass
class Episode:
    obs: list = field(default_factory=list)
    actions: list = field(default_factory=list)
    rewards: list = field(default_factory=list)
    logps: list = field(default_factory=list)
    values: list = field(default_factory=list)
    terminated: bool = False
    truncated: bool = False
    last_value: float = 0.0
    final_obs: Any = None     # obs after the last step (off-policy)
    # Recurrent policies: the module carry at this episode chunk's
    # FIRST step (zeros right after a reset; the live carry when a
    # chunk continues across sample() calls). The learner replays
    # from it so BPTT segments see their true rollout state.
    state_in: Any = None
    # False when this chunk CONTINUES an episode whose head was
    # collected in an earlier sample() call — evaluation must not
    # count such tails as full episodes.
    started_at_reset: bool = True

    @property
    def length(self) -> int:
        return len(self.actions)

    @property
    def total_reward(self) -> float:
        return float(sum(self.rewards))


@ray_tpu_torch.remote
class EnvRunner:
    """One sampling actor: vectorized-ish env loop with a host policy."""

    def __init__(self, env_maker_or_name, policy_config: dict,
                 seed: int = 0, policy: str = "categorical",
                 env_to_module=None, module_to_env=None):
        import torch

        from ray_tpu_torch.rllib.connectors import ConnectorPipelineV2
        torch.set_num_threads(1)
        # ConnectorV2 pipelines (reference: connector_pipeline_v2.py):
        # obs flow through env_to_module before the policy forward;
        # policy outputs flow through module_to_env before env.step.
        self.env_to_module = ConnectorPipelineV2(env_to_module or [])
        self.module_to_env = ConnectorPipelineV2(module_to_env or [])

        if isinstance(env_maker_or_name, str):
            # tune.register_env names first (cluster KV — names
            # registered on the driver resolve inside runner actors),
            # then gymnasium ids (reference: tune/registry.py).
            from ray_tpu_torch.tune.registry import get_registered_env
            maker = get_registered_env(env_maker_or_name)
            if maker is not None:
                self.env = maker()
            else:
                import gymnasium
                self.env = gymnasium.make(env_maker_or_name)
        else:
            self.env = env_maker_or_name()
        self.rng = np.random.default_rng(seed)
        self.policy = policy
        self.epsilon = 1.0          # epsilon_greedy only
        self._gen = torch.Generator().manual_seed(int(seed))  # gaussian
        if policy == "categorical":
            from ray_tpu_torch.rllib.catalog import build_actor_critic
            self.model = build_actor_critic(policy_config, "cpu", seed)
        elif policy == "recurrent":
            from ray_tpu_torch.rllib.catalog import (
                build_recurrent_actor_critic,
            )
            self.model = build_recurrent_actor_critic(policy_config, "cpu",
                                                      seed)
        elif policy == "dreamer":
            # World-model rollout policy (dreamer.py): recurrent
            # protocol + a feed_action hook so the chosen action
            # enters the next step's latent dynamics.
            from ray_tpu_torch.rllib.dreamer import build_dreamer_policy
            self.model = build_dreamer_policy(policy_config, "cpu", seed)
        elif policy == "epsilon_greedy":
            from ray_tpu_torch.rllib.catalog import build_q_network
            self.model = build_q_network(policy_config, "cpu", seed)
        elif policy == "gaussian":
            from ray_tpu_torch.rllib.models import (
                ContinuousConfig, SquashedGaussianActor,
            )
            self.model = SquashedGaussianActor(
                ContinuousConfig(**policy_config), "cpu", seed)
        else:
            raise ValueError(f"unknown policy {policy!r}")
        self._stateful = policy in ("recurrent", "dreamer")
        if self._stateful:
            # Stateful rollout: the carry advances per step and
            # resets at episode boundaries.
            self._carry = self.model.initial_state(1)
        self._obs, _ = self.env.reset(seed=seed)
        self._at_reset = True       # no steps taken since env reset
        # Transformed current obs: each observation passes through the
        # (possibly stateful) env_to_module pipeline EXACTLY once —
        # bootstrap values and episode records reuse this cache, so
        # FrameStack/NormalizeObs state never double-counts a frame.
        self._tobs = np.asarray(self.env_to_module(
            np.asarray(self._obs, np.float32), {"reset": True}),
            dtype=np.float32)

    def set_weights(self, params) -> bool:
        """Load ``params`` (CPU tensors or numpy by name) in place."""
        from ray_tpu_torch.rllib.learner import load_weights
        load_weights(self.model, params)
        return True

    def _fwd(self, obs, *carry):
        import torch

        with torch.inference_mode():
            return self.model(torch.from_numpy(obs), *carry)

    def set_epsilon(self, epsilon: float) -> bool:
        self.epsilon = float(epsilon)
        return True

    def _act(self, obs):
        """Policy-dependent action selection on host.
        Returns (env_action, stored_action, logp, value)."""
        import torch

        if self.policy == "categorical":
            logits, value = self._fwd(obs[None])
            probs = torch.softmax(logits[0], -1).numpy()
            action = int(self.rng.choice(len(probs), p=probs))
            logp = float(np.log(probs[action] + 1e-9))
            return action, action, logp, float(value[0])
        if self._stateful:
            logits, value, self._carry = self._fwd(obs[None], self._carry)
            probs = torch.softmax(logits[0], -1).numpy()
            action = int(self.rng.choice(len(probs), p=probs))
            logp = float(np.log(probs[action] + 1e-9))
            if hasattr(self.model, "feed_action"):
                # Dreamer-class policies: the action taken feeds the
                # NEXT step's latent dynamics.
                self._carry = self.model.feed_action(self._carry, action)
            return action, action, logp, float(value[0])
        if self.policy == "epsilon_greedy":
            q = self._fwd(obs[None])[0].numpy()
            if self.rng.random() < self.epsilon:
                action = int(self.rng.integers(len(q)))
            else:
                action = int(np.argmax(q))
            return action, action, 0.0, float(q[action])
        # gaussian (SAC)
        from ray_tpu_torch.rllib.models import SquashedGaussianActor
        mu, log_std = self._fwd(obs[None])
        a, logp = SquashedGaussianActor.sample(mu, log_std, self._gen)
        a = a[0].numpy().astype(np.float32)
        return a, a, float(logp[0]), 0.0

    def _new_episode(self) -> Episode:
        ep = Episode(started_at_reset=self._at_reset)
        if self._stateful:
            ep.state_in = self._carry[0].numpy().copy()
        return ep

    def sample(self, num_steps: int) -> list:
        """Collect ~num_steps of experience as Episode chunks."""
        episodes: list[Episode] = []
        ep = self._new_episode()
        for _ in range(num_steps):
            obs = self._tobs
            env_action, action, logp, value = self._act(obs)
            env_action = self.module_to_env(env_action, {})
            next_obs, reward, term, trunc, _ = self.env.step(env_action)
            self._at_reset = False
            ep.obs.append(obs)
            ep.actions.append(action)
            ep.rewards.append(float(reward))
            ep.logps.append(logp)
            ep.values.append(value)
            self._obs = next_obs
            self._tobs = np.asarray(self.env_to_module(
                np.asarray(next_obs, np.float32), {"reset": False}),
                dtype=np.float32)
            if term or trunc:
                ep.terminated, ep.truncated = term, trunc
                ep.last_value = 0.0
                # final_obs lives in the SAME (transformed) space as
                # ep.obs — off-policy consumers concatenate them.
                ep.final_obs = self._tobs
                episodes.append(ep)
                if self._stateful:
                    self._carry = self.model.initial_state(1)
                self._at_reset = True
                ep = self._new_episode()
                self._obs, _ = self.env.reset()
                self._tobs = np.asarray(self.env_to_module(
                    np.asarray(self._obs, np.float32),
                    {"reset": True}), dtype=np.float32)
        if ep.length:
            if self.policy == "categorical":
                _, last_v = self._fwd(self._tobs[None])
                ep.last_value = float(last_v[0])
            elif self._stateful:
                _, last_v, _c = self._fwd(self._tobs[None], self._carry)
                ep.last_value = float(last_v[0])
            ep.final_obs = self._tobs
            episodes.append(ep)
        return episodes

    def ping(self) -> str:
        return "ok"


class EnvRunnerGroup:
    """Manages N runner actors; tolerates runner loss by respawning
    (reference: EnvRunnerGroup probe-and-restore)."""

    def __init__(self, env_maker_or_name, policy_config: dict,
                 num_runners: int = 2, seed: int = 0,
                 policy: str = "categorical",
                 env_to_module=None, module_to_env=None):
        self._maker = env_maker_or_name
        self._policy_config = policy_config
        self._seed = seed
        self._policy = policy
        self._e2m = env_to_module
        self._m2e = module_to_env
        if isinstance(env_maker_or_name, str):
            # pre-init tune.register_env registrations reach the KV
            # before the runner actors (in worker processes) resolve
            from ray_tpu_torch.tune.registry import flush_pending
            flush_pending()
        self.runners = [
            EnvRunner.remote(env_maker_or_name, policy_config,
                             seed + i, policy,
                             env_to_module, module_to_env)
            for i in range(num_runners)
        ]

    def sample(self, steps_per_runner: int) -> list[Episode]:
        return [ep for chunks in
                self.sample_per_runner(steps_per_runner)
                for ep in chunks]

    def sample_per_runner(self, steps_per_runner: int
                          ) -> list[list[Episode]]:
        """Per-runner episode-chunk lists (order within each runner
        preserved — evaluation stitches multi-round episodes on it).
        A lost runner is respawned and contributes [] this round."""
        refs = [r.sample.remote(steps_per_runner) for r in self.runners]
        out: list[list[Episode]] = []
        for i, ref in enumerate(refs):
            try:
                out.append(ray_tpu_torch.get(ref, timeout=300))
            except Exception:  # noqa: BLE001 — respawn lost runner
                self.runners[i] = EnvRunner.remote(
                    self._maker, self._policy_config,
                    self._seed + i + 1000, self._policy,
                    self._e2m, self._m2e)
                out.append([])
        return out

    def set_weights(self, params) -> None:
        ref = ray_tpu_torch.put(params)   # broadcast via object store
        ray_tpu_torch.get([r.set_weights.remote(ref) for r in self.runners],
                    timeout=120)

    def set_epsilon(self, epsilon: float) -> None:
        ray_tpu_torch.get([r.set_epsilon.remote(epsilon)
                     for r in self.runners], timeout=120)

    def shutdown(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass


def evaluate_policy(runners: "EnvRunnerGroup",
                    num_episodes: int = 10,
                    max_rounds: int = 50) -> dict:
    """Evaluate the runners' CURRENT weights over ``num_episodes``
    COMPLETE episodes (reference: Algorithm.evaluate / evaluation
    EnvRunners; the training runners double as evaluators because
    weights are pushed eagerly after every update).

    Chunks are stitched PER RUNNER: sample() yields episode chunks,
    and an episode longer than one round spans several chunks — the
    per-runner pending accumulator carries reward/length across
    rounds, so long episodes are counted exactly. A pending head
    whose first chunk did NOT start at an env reset is the tail of a
    TRAINING episode and is discarded at completion (its reward
    total would be a lie)."""
    pending = [None] * len(runners.runners)   # (reward, length, at_reset)
    rewards: list[float] = []
    lengths: list[int] = []
    rounds = 0
    while len(rewards) < num_episodes and rounds < max_rounds:
        per_runner = runners.sample_per_runner(256)
        for i, chunks in enumerate(per_runner):
            for ep in chunks:
                if pending[i] is None:
                    pending[i] = [0.0, 0, ep.started_at_reset]
                pending[i][0] += ep.total_reward
                pending[i][1] += ep.length
                if ep.terminated or ep.truncated:
                    r, ln, clean = pending[i]
                    pending[i] = None
                    if clean:
                        rewards.append(r)
                        lengths.append(ln)
        rounds += 1
    rewards, lengths = rewards[:num_episodes], lengths[:num_episodes]
    n = len(rewards)
    return {
        "evaluation": {
            "episodes": n,
            "episode_reward_mean": (sum(rewards) / n) if n else
            float("nan"),
            "episode_reward_min": min(rewards) if n else float("nan"),
            "episode_reward_max": max(rewards) if n else float("nan"),
            "episode_len_mean": (sum(lengths) / n) if n else
            float("nan"),
        }
    }


class SupportsEvaluation:
    """Default Algorithm.evaluate over the training runner group —
    ONE implementation shared by every runner-backed algorithm
    (subclasses override to adjust exploration, e.g. DQN zeroes
    epsilon for greedy evaluation)."""

    def evaluate(self, num_episodes: int = 10) -> dict:
        return evaluate_policy(self.runners, num_episodes)
