"""APPO — asynchronous PPO (PPO surrogate on the IMPALA architecture).

Counterpart of ``ray_tpu/rllib/appo.py``. Reference analog:
rllib/algorithms/appo/ — env runners sample with stale weights (decoupled
via ``broadcast_interval`` like IMPALA), the learner corrects
off-policyness with V-trace, and the policy update uses PPO's clipped
surrogate on the V-trace advantages instead of IMPALA's plain
importance-weighted policy gradient. Everything but the policy-gradient
term (batching, V-trace, bootstrap handling, the captured step, the
training driver) is :class:`ImpalaLearner`'s and :class:`Impala`'s.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ray_tpu_torch.rllib.impala import (
    Impala,
    ImpalaConfig,
    ImpalaHyperparams,
    ImpalaLearner,
)


@dataclass
class APPOHyperparams(ImpalaHyperparams):
    clip_param: float = 0.2         # PPO surrogate clip
    optimizer: str = "adam"         # small-batch default


class APPOLearner(ImpalaLearner):
    def _policy_loss(self, t: dict):
        """PPO clipped surrogate on the V-trace advantages; the ratio is
        differentiated (IMPALA detaches its clipped weight)."""
        hp = self.hp
        surr1 = t["rho"] * t["adv"]
        surr2 = torch.clamp(t["rho"], 1 - hp.clip_param,
                            1 + hp.clip_param) * t["adv"]
        return -(torch.minimum(surr1, surr2)
                 * t["mask"]).sum() / t["denom"]


@dataclass
class APPOConfig(ImpalaConfig):
    hparams: APPOHyperparams = field(default_factory=APPOHyperparams)

    def build(self) -> "APPO":
        return APPO(self)


class APPO(Impala):
    learner_cls = APPOLearner
