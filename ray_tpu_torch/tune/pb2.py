"""PB2: Population Based Bandits.

Reference analog: ``python/ray/tune/schedulers/pb2.py`` (PB2 —
Parker-Holder et al., NeurIPS 2020). PBT's exploit mechanism is kept
verbatim (bottom-quantile trials restart from a top-quantile donor's
checkpoint); the EXPLORE step replaces PBT's random 0.8x/1.2x
perturbation with a Gaussian-process bandit: observed
(time, hyperparams) -> reward-change pairs fit a GP, and the new
config maximizes a UCB acquisition over candidates sampled inside
the declared bounds. Against the reference's GPy dependency this is
a dependency-free numpy GP (RBF kernel + jittered Cholesky), which
is the whole of what PB2 needs.

Continuous hyperparameters must declare ``[low, high]`` numeric
bounds (log-scaled selection when ``log=True`` ranges are given via
tune.loguniform); categorical/list parameters fall back to PBT's
neighbor-shift rules.
"""

from __future__ import annotations

import math
import random

import numpy as np

from ray_tpu_torch.tune.schedulers import PopulationBasedTraining


class _TinyGP:
    """RBF-kernel GP regression, dependency-free.

    Inputs are expected pre-normalized to ~[0, 1]^d; targets are
    standardized by the caller. Lengthscale/noise are fixed
    hyperpriors (the reference tunes them by marginal likelihood;
    with PB2's tiny datasets — tens of points — fixed values are
    within noise of the optimum and keep this O(n^3) fit trivial).
    """

    def __init__(self, lengthscale: float = 0.3,
                 noise: float = 1e-2):
        self.l2 = 2.0 * lengthscale ** 2
        self.noise = noise
        self._X = None
        self._alpha = None
        self._L = None

    def _k(self, A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / self.l2)

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        K = self._k(X, X) + self.noise * np.eye(len(X))
        # Jittered Cholesky: tiny duplicate-heavy panels can be
        # numerically semidefinite.
        for jitter in (0.0, 1e-8, 1e-6, 1e-4):
            try:
                self._L = np.linalg.cholesky(
                    K + jitter * np.eye(len(X)))
                break
            except np.linalg.LinAlgError:
                continue
        else:  # pragma: no cover - last-resort fallback
            self._L = np.linalg.cholesky(K + 1e-2 * np.eye(len(X)))
        self._X = X
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, y))

    def predict(self, Xs: np.ndarray):
        Ks = self._k(Xs, self._X)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
        return mu, np.sqrt(var)


class PB2(PopulationBasedTraining):
    """PBT with GP-bandit exploration over continuous bounds.

    ``hyperparam_bounds``: {name: [low, high]} continuous ranges the
    GP searches; anything in ``hyperparam_mutations`` keeps PBT's
    random rules (categoricals). At least one of the two must be
    given.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_bounds: dict | None = None,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25,
                 ucb_kappa: float = 1.0,
                 n_candidates: int = 64,
                 seed: int | None = None):
        if not hyperparam_bounds and not hyperparam_mutations:
            raise ValueError(
                "PB2 needs hyperparam_bounds (continuous GP search) "
                "and/or hyperparam_mutations (PBT rules)")
        super().__init__(
            metric=metric, mode=mode, time_attr=time_attr,
            perturbation_interval=perturbation_interval,
            # PBT's ctor requires mutations; give it the categorical
            # set, or bounds re-expressed as resample lists (only
            # used on its fallback paths).
            hyperparam_mutations=(hyperparam_mutations
                                  or {k: list(v) for k, v in
                                      hyperparam_bounds.items()}),
            quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = {k: (float(v[0]), float(v[1]))
                       for k, v in (hyperparam_bounds or {}).items()}
        for k, (lo, hi) in self.bounds.items():
            if not hi > lo:
                raise ValueError(f"bounds for {k!r} need high > low")
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        self._np_rng = np.random.default_rng(seed)
        # Observations: per trial, last (t, score) to difference
        # against; global panel of (t, hyperparams) -> dscore.
        self._prev: dict[str, tuple[float, float]] = {}
        self._obs_X: list[list[float]] = []
        self._obs_dy: list[float] = []
        self._t_max = 1.0

    # -- observation collection --

    def on_result(self, trial_id: str, result: dict) -> str:
        v = float(result[self.metric])
        score = v if self.mode == "max" else -v
        t = float(result.get(self.time_attr, 0))
        self._t_max = max(self._t_max, t, 1.0)
        prev = self._prev.get(trial_id)
        cfg = self._config.get(trial_id, {})
        if prev is not None and self.bounds and all(
                isinstance(cfg.get(k), (int, float))
                for k in self.bounds):
            pt, pscore = prev
            if t > pt:
                self._obs_X.append(
                    [t] + [float(cfg[k]) for k in self.bounds])
                self._obs_dy.append((score - pscore) / (t - pt))
        self._prev[trial_id] = (t, score)
        return super().on_result(trial_id, result)

    # -- GP-guided explore --

    def _normalize(self, rows: np.ndarray) -> np.ndarray:
        out = np.empty_like(rows, dtype=np.float64)
        out[:, 0] = rows[:, 0] / self._t_max
        for j, (k, (lo, hi)) in enumerate(self.bounds.items()):
            out[:, j + 1] = (rows[:, j + 1] - lo) / (hi - lo)
        return out

    def _explore(self, config: dict) -> dict:
        out = dict(config)
        cat_mut = {k: v for k, v in self.mutations.items()
                   if k not in self.bounds}
        if cat_mut:
            saved = self.mutations
            self.mutations = cat_mut
            try:
                out = super()._explore(out)
            finally:
                self.mutations = saved
        if not self.bounds:
            return out
        names = list(self.bounds)
        lo = np.array([self.bounds[k][0] for k in names])
        hi = np.array([self.bounds[k][1] for k in names])
        cands = self._np_rng.uniform(lo, hi,
                                     (self.n_candidates, len(names)))
        if len(self._obs_X) >= 4:
            X = self._normalize(np.asarray(self._obs_X))
            y = np.asarray(self._obs_dy)
            std = y.std() or 1.0
            yn = (y - y.mean()) / std
            gp = _TinyGP()
            gp.fit(X, yn)
            t_next = np.full((len(cands), 1), min(
                1.0, (self._t_max + self.interval) / self._t_max))
            mu, sigma = gp.predict(self._normalize(
                np.hstack([t_next * self._t_max, cands])))
            pick = cands[int(np.argmax(mu + self.kappa * sigma))]
        else:
            # Cold start: not enough observations for a GP — uniform
            # exploration inside the bounds (the reference does the
            # same before its first fit).
            pick = cands[0]
        for k, v in zip(names, pick):
            old = config.get(k)
            out[k] = type(old)(v) if isinstance(old, int) else float(v)
        return out
