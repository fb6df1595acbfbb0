"""ConnectorV2 pipelines (reference: rllib/connectors/connector_v2.py
and connector_pipeline_v2.py, with the three pipeline slots of the new
API stack: env_to_module, module_to_env, learner).

Counterpart of ``ray_tpu/rllib/connectors.py``, which is numpy only and
is copied as it is. Connectors are pure numpy transforms that run on the
CPU side of the system — inside EnvRunner actors (obs in, actions out)
and in the learner's host path (episodes → train batch) BEFORE data goes
to the card. The captured update never sees them, so adding a connector
never captures the card's step again.

Pipelines are picklable (they ship to EnvRunner actors); stateful
connectors (NormalizeObs, FrameStack) keep their state inside the
actor that owns the pipeline.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable

import numpy as np


class ConnectorV2:
    """One transform stage. ``data`` is an observation (env_to_module),
    an action dict (module_to_env), or a list[Episode] / batch dict
    (learner). ``ctx`` carries episode boundaries ("reset": True on
    the first obs of an episode) for stateful connectors."""

    def __call__(self, data, ctx: dict | None = None):
        raise NotImplementedError

    def reset_state(self) -> None:
        """Called at episode boundaries for stateful connectors."""


class ConnectorPipelineV2(ConnectorV2):
    def __init__(self, connectors: list | None = None):
        self.connectors: list[ConnectorV2] = list(connectors or ())

    def __call__(self, data, ctx: dict | None = None):
        for c in self.connectors:
            data = c(data, ctx)
        return data

    def reset_state(self) -> None:
        for c in self.connectors:
            c.reset_state()

    # pipeline surgery (reference: prepend/append/insert_before/after)
    def append(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.insert(0, connector)
        return self

    def insert_before(self, cls: type,
                      connector: ConnectorV2) -> "ConnectorPipelineV2":
        for i, c in enumerate(self.connectors):
            if isinstance(c, cls):
                self.connectors.insert(i, connector)
                return self
        raise ValueError(f"no connector of type {cls.__name__}")

    def insert_after(self, cls: type,
                     connector: ConnectorV2) -> "ConnectorPipelineV2":
        for i, c in enumerate(self.connectors):
            if isinstance(c, cls):
                self.connectors.insert(i + 1, connector)
                return self
        raise ValueError(f"no connector of type {cls.__name__}")

    def remove(self, cls: type) -> "ConnectorPipelineV2":
        self.connectors = [c for c in self.connectors
                           if not isinstance(c, cls)]
        return self

    def __len__(self) -> int:
        return len(self.connectors)


# -- env_to_module ----------------------------------------------------------


class FlattenObs(ConnectorV2):
    """Dict/tuple/ndim>1 observations → flat float32 vector."""

    def __call__(self, obs, ctx=None):
        return _flatten(obs)


def _flatten(obs):
    if isinstance(obs, dict):
        parts = [_flatten(obs[k]) for k in sorted(obs)]
        return np.concatenate(parts) if parts else np.zeros(
            0, np.float32)
    if isinstance(obs, (tuple, list)):
        parts = [_flatten(o) for o in obs]
        return np.concatenate(parts) if parts else np.zeros(
            0, np.float32)
    return np.asarray(obs, np.float32).ravel()


class ClipObs(ConnectorV2):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, obs, ctx=None):
        return np.clip(np.asarray(obs, np.float32), self.low,
                       self.high)


class NormalizeObs(ConnectorV2):
    """Running mean/std normalization (Welford). State lives in the
    EnvRunner actor holding this pipeline — the learner gets already
    normalized observations through the sampled episodes."""

    def __init__(self, eps: float = 1e-8, clip: float = 10.0):
        self.eps, self.clip = eps, clip
        self.count = 0
        self.mean: np.ndarray | None = None
        self.m2: np.ndarray | None = None

    def __call__(self, obs, ctx=None):
        x = np.asarray(obs, np.float64).ravel()
        if self.mean is None:
            self.mean = np.zeros_like(x)
            self.m2 = np.zeros_like(x)
        self.count += 1
        delta = x - self.mean
        self.mean = self.mean + delta / self.count
        self.m2 = self.m2 + delta * (x - self.mean)
        var = (self.m2 / max(self.count - 1, 1)) if self.count > 1 \
            else np.ones_like(x)
        out = (x - self.mean) / np.sqrt(var + self.eps)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)


class FrameStack(ConnectorV2):
    """Stack the last k observations (episode-local; resets on
    episode boundaries via ctx["reset"])."""

    def __init__(self, k: int = 4):
        self.k = k
        self._frames: deque = deque(maxlen=k)

    def __call__(self, obs, ctx=None):
        x = np.asarray(obs, np.float32)
        if ctx and ctx.get("reset"):
            self._frames.clear()
        while len(self._frames) < self.k - 1:
            self._frames.append(np.zeros_like(x))
        self._frames.append(x)
        return np.concatenate([f.ravel() for f in self._frames])

    def reset_state(self) -> None:
        self._frames.clear()


class Lambda(ConnectorV2):
    """Escape hatch: wrap any ``fn(data) -> data``."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, data, ctx=None):
        return self.fn(data)


# -- module_to_env ----------------------------------------------------------


class ClipActions(ConnectorV2):
    def __init__(self, low, high):
        self.low = np.asarray(low)
        self.high = np.asarray(high)

    def __call__(self, action, ctx=None):
        return np.clip(action, self.low, self.high)


class UnsquashActions(ConnectorV2):
    """Map a tanh-squashed [-1, 1] policy output onto the env's box
    bounds (reference: unsquash_action in module_to_env)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, action, ctx=None):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)


# -- learner ----------------------------------------------------------------


class EpisodesToBatch(ConnectorV2):
    """Concatenate Episode objects into flat train-batch arrays."""

    def __call__(self, episodes, ctx=None):
        obs = np.concatenate(
            [np.asarray(e.obs, np.float32) for e in episodes])
        return {
            "obs": obs,
            "actions": np.concatenate(
                [np.asarray(e.actions) for e in episodes]),
            "rewards": np.concatenate(
                [np.asarray(e.rewards, np.float32)
                 for e in episodes]),
            "logps": np.concatenate(
                [np.asarray(e.logps, np.float32) for e in episodes]),
        }


class GAE(ConnectorV2):
    """Generalized advantage estimation over a list[Episode]; emits
    the flat batch with 'advantages' and 'value_targets' added
    (reference: the learner connector pipeline's GAE piece)."""

    def __init__(self, gamma: float = 0.99, lam: float = 0.95,
                 normalize: bool = True):
        self.gamma, self.lam, self.normalize = gamma, lam, normalize

    def __call__(self, episodes, ctx=None):
        advs, targets = [], []
        for e in episodes:
            r = np.asarray(e.rewards, np.float32)
            v = np.asarray(e.values, np.float32)
            boot = 0.0 if e.terminated else float(e.last_value)
            v_next = np.append(v[1:], boot)
            delta = r + self.gamma * v_next - v
            a = np.zeros_like(delta)
            acc = 0.0
            for t in range(len(delta) - 1, -1, -1):
                acc = delta[t] + self.gamma * self.lam * acc
                a[t] = acc
            advs.append(a)
            targets.append(a + v)
        batch = EpisodesToBatch()(episodes)
        adv = np.concatenate(advs)
        if self.normalize and adv.size > 1:
            adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        batch["advantages"] = adv
        batch["value_targets"] = np.concatenate(targets)
        return batch
