"""RLModule analog: actor-critic and Q policies as ``torch.nn.Module``s.

Counterpart of ``ray_tpu/rllib/models.py``. Layer names are flax's, so
``load_jax_params`` carries a flax tree across (``catalog``); the
initial weights come from a CPU ``torch.Generator(seed)`` with flax's
distributions, on ``device`` (the card by default, ``"cpu"`` when
asked). ``SquashedGaussianActor.sample`` draws from a
``torch.Generator`` where the JAX one takes a key (equal in
distribution, not in stream), or takes its noise as a tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.rllib.catalog import _Carried, _generator, dense


@dataclass(frozen=True)
class ActorCriticConfig:
    obs_dim: int
    num_actions: int
    hidden: tuple[int, ...] = (64, 64)
    dtype: Any = torch.float32


def _trunk(module: nn.Module, prefix: str, widths: tuple, gen,
           dtype) -> None:
    for i in range(len(widths) - 1):
        module.add_module(f"{prefix}fc{i}",
                          dense(widths[i], widths[i + 1], "cpu", gen, dtype))


def _run_trunk(module: nn.Module, prefix: str, n: int, x, act):
    for i in range(n):
        x = act(getattr(module, f"{prefix}fc{i}")(x))
    return x


class ActorCritic(_Carried):
    """Discrete-action policy + value head (the RLModule analog):
    ``forward(obs) -> (logits, value)``."""

    def __init__(self, config: ActorCriticConfig, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = _generator(seed)
        cfg = self.config = config
        _trunk(self, "", (cfg.obs_dim, *cfg.hidden), gen, cfg.dtype)
        width = cfg.hidden[-1] if cfg.hidden else cfg.obs_dim
        self.pi = dense(width, cfg.num_actions, "cpu", gen, cfg.dtype,
                        scale=0.01)
        self.vf = dense(width, 1, "cpu", gen, cfg.dtype, scale=1.0)
        self.to(device)

    def forward(self, obs):
        x = _run_trunk(self, "", len(self.config.hidden),
                       obs.to(self.config.dtype), torch.tanh)
        return self.pi(x), self.vf(x)[..., 0]


class QNetwork(_Carried):
    """State-action value net for DQN (reference:
    rllib/algorithms/dqn — the RLModule's Q head)."""

    def __init__(self, config: ActorCriticConfig, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = _generator(seed)
        cfg = self.config = config
        _trunk(self, "", (cfg.obs_dim, *cfg.hidden), gen, cfg.dtype)
        width = cfg.hidden[-1] if cfg.hidden else cfg.obs_dim
        self.q = dense(width, cfg.num_actions, "cpu", gen, cfg.dtype)
        self.to(device)

    def forward(self, obs):
        x = _run_trunk(self, "", len(self.config.hidden),
                       obs.to(self.config.dtype), torch.relu)
        return self.q(x)


@dataclass(frozen=True)
class ContinuousConfig:
    obs_dim: int
    action_dim: int
    hidden: tuple[int, ...] = (64, 64)
    dtype: Any = torch.float32


class SquashedGaussianActor(_Carried):
    """Tanh-squashed gaussian policy (SAC actor):
    ``forward(obs) -> (mu, log_std)``, log_std clipped to
    [LOG_STD_MIN, LOG_STD_MAX]."""

    LOG_STD_MIN: float = -10.0
    LOG_STD_MAX: float = 2.0

    def __init__(self, config: ContinuousConfig, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = _generator(seed)
        cfg = self.config = config
        _trunk(self, "", (cfg.obs_dim, *cfg.hidden), gen, cfg.dtype)
        width = cfg.hidden[-1] if cfg.hidden else cfg.obs_dim
        self.mu = dense(width, cfg.action_dim, "cpu", gen, cfg.dtype)
        self.log_std = dense(width, cfg.action_dim, "cpu", gen, cfg.dtype)
        self.to(device)

    def forward(self, obs):
        x = _run_trunk(self, "", len(self.config.hidden),
                       obs.to(self.config.dtype), torch.relu)
        log_std = self.log_std(x).clamp(self.LOG_STD_MIN, self.LOG_STD_MAX)
        return self.mu(x), log_std

    @staticmethod
    def sample(mu, log_std, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None):
        """Reparameterized tanh-gaussian sample with log-prob; the standard
        normal noise is ``noise`` when given (a captured step's input, or
        JAX's own draw in a test), else drawn from ``generator`` (on
        ``mu``'s device)."""
        std = torch.exp(log_std)
        eps = noise if noise is not None else torch.randn(
            mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
        pre = mu + std * eps
        a = torch.tanh(pre)
        logp = (-0.5 * (eps ** 2 + 2 * log_std
                        + math.log(2 * math.pi))).sum(-1)
        # tanh change-of-variables correction
        logp = logp - torch.log(1 - a ** 2 + 1e-6).sum(-1)
        return a, logp


class TwinQ(_Carried):
    """Two independent Q(s, a) critics (SAC's clipped double-Q)."""

    def __init__(self, config: ContinuousConfig, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = _generator(seed)
        cfg = self.config = config
        width = cfg.hidden[-1] if cfg.hidden else cfg.obs_dim + \
            cfg.action_dim
        for head in ("q1", "q2"):
            _trunk(self, f"{head}_", (cfg.obs_dim + cfg.action_dim,
                                      *cfg.hidden), gen, cfg.dtype)
            self.add_module(head, dense(width, 1, "cpu", gen, cfg.dtype))
        self.to(device)

    def forward(self, obs, action):
        cfg = self.config
        x = torch.cat([obs.to(cfg.dtype), action.to(cfg.dtype)], dim=-1)
        outs = []
        for head in ("q1", "q2"):
            h = _run_trunk(self, f"{head}_", len(cfg.hidden), x, torch.relu)
            outs.append(getattr(self, head)(h)[..., 0])
        return outs[0], outs[1]
