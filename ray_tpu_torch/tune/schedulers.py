"""Trial schedulers: FIFO, ASHA, HyperBand, median-stopping, PBT.

Reference analogs (SURVEY.md §2.3 Tune):
- ASHA: python/ray/tune/schedulers/async_hyperband.py — asynchronous
  successive halving: rungs at min_t * eta^k; a trial continues past a
  rung only if its metric is in the top 1/eta at that rung.
- HyperBand: python/ray/tune/schedulers/hyperband.py — multiple
  brackets trading off grace period vs. aggressiveness; here each
  bracket runs ASHA-style (asynchronous) rather than pausing trials,
  which matches our restartless trial actors.
- Median stopping: schedulers/median_stopping_rule.py — stop a trial
  whose best result is worse than the median of other trials' running
  averages at the same step.
- PBT: schedulers/pbt.py — bottom-quantile trials EXPLOIT a
  top-quantile donor (restore its checkpoint) and EXPLORE by mutating
  hyperparameters; implemented via trial restart from the donor's
  checkpoint (the reference pauses/unpauses actors; ours restarts the
  trial actor with ``restored_checkpoint_dir``, same semantics).

Scheduler protocol (duck-typed; all methods optional except
``on_result``):
  on_trial_add(trial_id, config)        — trial created
  on_result(trial_id, result) -> str    — CONTINUE | STOP | EXPLOIT
  on_checkpoint(trial_id, ckpt_dir)     — a checkpoint was persisted
  on_trial_complete(trial_id)           — trial left the running set
  exploit(trial_id) -> (config, ckpt)   — PBT only, after EXPLOIT
"""

from __future__ import annotations

import random
from collections import defaultdict
from dataclasses import dataclass, field

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"


class FIFOScheduler:
    def on_result(self, trial_id: str, result: dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        pass


@dataclass
class ASHAScheduler:
    metric: str = "loss"
    mode: str = "min"                 # "min" | "max"
    time_attr: str = "training_iteration"
    max_t: int = 100
    grace_period: int = 1
    reduction_factor: int = 4

    _rungs: list[int] = field(default_factory=list)
    _rung_results: dict[int, list[float]] = field(
        default_factory=lambda: defaultdict(list))
    _trial_rung: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        t = self.grace_period
        while t < self.max_t:
            self._rungs.append(t)
            t *= self.reduction_factor
        self._rungs = sorted(self._rungs, reverse=True)

    def _value(self, result: dict) -> float:
        v = float(result[self.metric])
        return -v if self.mode == "max" else v

    def on_result(self, trial_id: str, result: dict) -> str:
        t = int(result.get(self.time_attr, 0))
        if t >= self.max_t:
            return STOP  # budget exhausted (normal completion)
        for rung in self._rungs:     # highest rung first (ASHA rule)
            if t >= rung and self._trial_rung.get(trial_id, -1) < rung:
                self._trial_rung[trial_id] = rung
                value = self._value(result)
                peers = self._rung_results[rung]
                peers.append(value)
                if len(peers) >= self.reduction_factor:
                    k = max(1, len(peers) // self.reduction_factor)
                    cutoff = sorted(peers)[k - 1]
                    if value > cutoff:
                        return STOP
                return CONTINUE
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        self._trial_rung.pop(trial_id, None)


class HyperBandScheduler:
    """Bracketed successive halving. Each new trial is assigned
    round-robin to one of ``s_max+1`` brackets; bracket ``s`` runs an
    ASHA rung ladder with grace period ``max_t / eta^s`` — so one
    bracket explores aggressively (tiny grace period) while another
    guarantees every trial ``max_t`` steps, the HyperBand tradeoff."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 max_t: int = 81, reduction_factor: int = 3):
        self.metric, self.mode = metric, mode
        eta = reduction_factor
        s_max = 0
        g = max_t
        while g >= eta:
            g //= eta
            s_max += 1
        self._brackets = [
            ASHAScheduler(metric=metric, mode=mode, time_attr=time_attr,
                          max_t=max_t,
                          grace_period=max(1, max_t // (eta ** s)),
                          reduction_factor=eta)
            for s in range(s_max + 1)
        ]
        self._assignment: dict[str, int] = {}
        self._next = 0

    def on_trial_add(self, trial_id: str, config: dict) -> None:
        self._assignment[trial_id] = self._next % len(self._brackets)
        self._next += 1

    def _bracket(self, trial_id: str) -> ASHAScheduler:
        if trial_id not in self._assignment:
            self.on_trial_add(trial_id, {})
        return self._brackets[self._assignment[trial_id]]

    def on_result(self, trial_id: str, result: dict) -> str:
        return self._bracket(trial_id).on_result(trial_id, result)

    def on_trial_complete(self, trial_id: str) -> None:
        self._bracket(trial_id).on_trial_complete(trial_id)
        self._assignment.pop(trial_id, None)


class MedianStoppingRule:
    """Stop a trial at step t when its best metric so far is worse
    than the median of the *running averages* of all other trials that
    have reported at step >= t (reference:
    python/ray/tune/schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._history: dict[str, list[tuple[int, float]]] = \
            defaultdict(list)

    def _value(self, result: dict) -> float:
        v = float(result[self.metric])
        return -v if self.mode == "max" else v

    def on_result(self, trial_id: str, result: dict) -> str:
        t = int(result.get(self.time_attr, 0))
        self._history[trial_id].append((t, self._value(result)))
        if t < self.grace_period:
            return CONTINUE
        avgs = []
        for other, hist in self._history.items():
            if other == trial_id:
                continue
            vals = [v for (step, v) in hist if step <= t]
            if vals:
                avgs.append(sum(vals) / len(vals))
        if len(avgs) < self.min_samples:
            return CONTINUE
        avgs.sort()
        median = avgs[len(avgs) // 2]
        best = min(v for (_, v) in self._history[trial_id])
        return STOP if best > median else CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        pass


class PopulationBasedTraining:
    """PBT (reference: python/ray/tune/schedulers/pbt.py).

    Every ``perturbation_interval`` steps a trial is scored against
    the population: bottom-quantile trials get the EXPLOIT decision —
    the controller restarts them from a top-quantile donor's latest
    checkpoint with a mutated config (explore: resample with
    ``resample_probability`` else multiply continuous params by
    0.8/1.2, shift categorical to a neighbor — the reference's
    ``explore()`` rules).
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: int | None = None):
        if not hyperparam_mutations:
            raise ValueError("hyperparam_mutations is required for PBT")
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self._rng = random.Random(seed)
        self._config: dict[str, dict] = {}
        self._score: dict[str, float] = {}         # higher = better
        self._ckpt: dict[str, str | None] = {}
        self._last_perturb: dict[str, int] = {}
        self.exploit_count = 0

    # -- controller hooks --

    def on_trial_add(self, trial_id: str, config: dict) -> None:
        self._config[trial_id] = dict(config)
        self._last_perturb.setdefault(trial_id, 0)

    def on_checkpoint(self, trial_id: str, ckpt_dir: str) -> None:
        self._ckpt[trial_id] = ckpt_dir

    def on_result(self, trial_id: str, result: dict) -> str:
        v = float(result[self.metric])
        self._score[trial_id] = v if self.mode == "max" else -v
        t = int(result.get(self.time_attr, 0))
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        lower, upper = self._quantiles()
        if trial_id in lower and upper:
            # donor must have a checkpoint to clone from
            donors = [u for u in upper if self._ckpt.get(u)]
            if donors:
                return EXPLOIT
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        self._score.pop(trial_id, None)

    def exploit(self, trial_id: str) -> tuple[dict, str]:
        """Pick a donor from the top quantile; return (mutated config,
        donor checkpoint dir)."""
        _, upper = self._quantiles()
        donors = [u for u in upper if self._ckpt.get(u)] or \
            [u for u in self._score if self._ckpt.get(u)]
        donor = self._rng.choice(donors)
        new_config = self._explore(self._config[donor])
        self._config[trial_id] = dict(new_config)
        self._last_perturb[trial_id] = self._last_perturb.get(donor, 0)
        self.exploit_count += 1
        return new_config, self._ckpt[donor]

    # -- internals --

    def _quantiles(self) -> tuple[list[str], list[str]]:
        trials = sorted(self._score, key=self._score.__getitem__)
        if len(trials) < 2:
            return [], []
        n = max(1, int(len(trials) * self.quantile))
        if n * 2 > len(trials):
            n = len(trials) // 2
        return trials[:n], trials[-n:]

    def _explore(self, config: dict) -> dict:
        from ray_tpu_torch.tune.search import _sample
        out = dict(config)
        for key, spec in self.mutations.items():
            old = out.get(key)
            if self._rng.random() < self.resample_p or old is None:
                out[key] = self._sample_spec(spec)
            elif isinstance(spec, list):
                idx = spec.index(old) if old in spec else 0
                step = self._rng.choice([-1, 1])
                out[key] = spec[max(0, min(len(spec) - 1, idx + step))]
            elif isinstance(old, (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                out[key] = type(old)(old * factor)
            else:
                out[key] = self._sample_spec(spec)
        return out

    def _sample_spec(self, spec):
        from ray_tpu_torch.tune import search as S
        if isinstance(spec, list):
            return self._rng.choice(spec)
        if callable(spec) and not isinstance(
                spec, (S._Choice, S._Uniform, S._LogUniform, S._RandInt,
                       S._GridSearch)):
            return spec()
        return S._sample(spec, self._rng)
