"""Search spaces and suggestion algorithms.

Reference analog: python/ray/tune/search/ — the basic variant
generator (grid + random sampling) plus a Searcher interface that
external algorithms (optuna-style) can implement.
"""

from __future__ import annotations

import itertools
import random
import types
from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class _GridSearch:
    values: tuple


@dataclass(frozen=True)
class _Choice:
    values: tuple


@dataclass(frozen=True)
class _Uniform:
    low: float
    high: float


@dataclass(frozen=True)
class _LogUniform:
    low: float
    high: float


@dataclass(frozen=True)
class _RandInt:
    low: int
    high: int


def grid_search(values) -> _GridSearch:
    return _GridSearch(tuple(values))


def choice(values) -> _Choice:
    return _Choice(tuple(values))


def uniform(low: float, high: float) -> _Uniform:
    return _Uniform(low, high)


def loguniform(low: float, high: float) -> _LogUniform:
    return _LogUniform(low, high)


def randint(low: int, high: int) -> _RandInt:
    return _RandInt(low, high)


@dataclass(frozen=True)
class _Quantized:
    """Quantized/derived continuous spec (reference: tune.quniform
    family) — sample the base spec, post-process."""
    base: object
    q: float | None = None
    as_int: bool = False


@dataclass(frozen=True)
class _Randn:
    mean: float = 0.0
    sd: float = 1.0


@dataclass(frozen=True)
class _SampleFrom:
    """tune.sample_from(fn): fn(spec_context) -> value. The callable
    receives the partially-sampled config (reference semantics allow
    dependent parameters)."""
    fn: object


def quniform(low: float, high: float, q: float) -> _Quantized:
    return _Quantized(_Uniform(low, high), q=q)


def qloguniform(low: float, high: float, q: float) -> _Quantized:
    return _Quantized(_LogUniform(low, high), q=q)


def qrandint(low: int, high: int, q: int) -> _Quantized:
    return _Quantized(_RandInt(low, high), q=float(q), as_int=True)


def lograndint(low: int, high: int) -> _Quantized:
    return _Quantized(_LogUniform(low, max(high - 1, low) + 1),
                      as_int=True)


def qlograndint(low: int, high: int, q: int) -> _Quantized:
    return _Quantized(_LogUniform(low, max(high - 1, low) + 1),
                      q=float(q), as_int=True)


def randn(mean: float = 0.0, sd: float = 1.0) -> _Randn:
    return _Randn(mean, sd)


def qrandn(mean: float, sd: float, q: float) -> _Quantized:
    return _Quantized(_Randn(mean, sd), q=q)


def sample_from(fn) -> _SampleFrom:
    return _SampleFrom(fn)


def _sample(spec, rng: random.Random, partial_config: dict | None = None):
    import math
    if isinstance(spec, (_Choice, _GridSearch)):
        # Samplers treat grid_search dims as categorical (the grid
        # semantics belong to BasicVariantGenerator's expansion).
        return rng.choice(list(spec.values))
    if isinstance(spec, _Uniform):
        return rng.uniform(spec.low, spec.high)
    if isinstance(spec, _LogUniform):
        return math.exp(rng.uniform(math.log(spec.low),
                                    math.log(spec.high)))
    if isinstance(spec, _RandInt):
        return rng.randrange(spec.low, spec.high)
    if isinstance(spec, _Randn):
        return rng.gauss(spec.mean, spec.sd)
    if isinstance(spec, _Quantized):
        v = _sample(spec.base, rng)
        if spec.q:
            v = round(v / spec.q) * spec.q
        return int(round(v)) if spec.as_int else float(v)
    if isinstance(spec, _SampleFrom):
        return spec.fn(types.SimpleNamespace(
            config=dict(partial_config or {})))
    if callable(spec):
        return spec()
    return spec


class Searcher:
    """Suggestion interface (reference: tune.search.Searcher).

    ``suggest`` returning None means either *exhausted* (when
    ``is_finished()`` is True) or *not ready yet* (a concurrency
    limiter holding back suggestions) — the controller re-polls in the
    latter case. Custom subclasses that don't override
    ``is_finished`` are treated as exhausted once ``suggest`` returns
    None with no trials in flight (the controller's fallback).
    """

    def suggest(self, trial_id: str) -> dict | None:
        raise NotImplementedError

    def is_finished(self) -> bool:
        return False

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        """Intermediate rung result (model-based searchers like BOHB
        learn from partial budgets; default no-op)."""

    def on_trial_complete(self, trial_id: str, result: dict | None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid axes are fully enumerated; every other axis is sampled per
    variant; the whole grid is repeated num_samples times (reference
    semantics: tune.run num_samples multiplies the grid)."""

    def __init__(self, param_space: dict, num_samples: int = 1,
                 seed: int | None = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self._variants = self._build()
        self._i = 0

    def _build(self) -> list[dict]:
        grid_keys = [k for k, v in self.param_space.items()
                     if isinstance(v, _GridSearch)]
        grids = [self.param_space[k].values for k in grid_keys]
        out = []
        for _ in range(self.num_samples):
            for combo in itertools.product(*grids) if grids else [()]:
                cfg = {}
                for k, v in self.param_space.items():
                    if k in grid_keys:
                        cfg[k] = combo[grid_keys.index(k)]
                    else:
                        cfg[k] = _sample(v, self.rng,
                                         partial_config=cfg)
                out.append(cfg)
        return out

    def total(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> dict | None:
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg

    def is_finished(self) -> bool:
        return self._i >= len(self._variants)


class RandomSearcher(Searcher):
    """Pure random sampling from the space, ``num_samples`` trials."""

    def __init__(self, param_space: dict, num_samples: int = 10,
                 seed: int | None = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self._n = 0

    def suggest(self, trial_id: str) -> dict | None:
        if self._n >= self.num_samples:
            return None
        self._n += 1
        return {k: _sample(v, self.rng)
                for k, v in self.param_space.items()}

    def is_finished(self) -> bool:
        return self._n >= self.num_samples


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (the algorithm behind the
    reference's OptunaSearch/HyperOptSearch default samplers,
    python/ray/tune/search/{optuna,hyperopt}/).

    After ``n_startup`` random trials, observations are split at the
    ``gamma`` quantile into good/bad sets per dimension; candidates
    are drawn from a Parzen (gaussian-kernel) density over the good
    set and ranked by the likelihood ratio l_good/l_bad. Categorical
    dims use smoothed count ratios. Pure numpy — no external deps.
    """

    def __init__(self, param_space: dict, metric: str = "loss",
                 mode: str = "min", num_samples: int = 32,
                 n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int | None = None):
        self.param_space = param_space
        self.metric, self.mode = metric, mode
        self.num_samples = num_samples
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._n = 0
        self._obs: list[tuple[dict, float]] = []   # (config, score↓)
        self._pending: dict[str, dict] = {}

    def suggest(self, trial_id: str) -> dict | None:
        if self._n >= self.num_samples:
            return None
        self._n += 1
        if len(self._obs) < self.n_startup:
            cfg = {k: _sample(v, self.rng)
                   for k, v in self.param_space.items()}
        else:
            cfg = self._tpe_suggest()
        self._pending[trial_id] = cfg
        return cfg

    def is_finished(self) -> bool:
        return self._n >= self.num_samples

    def on_trial_complete(self, trial_id: str, result: dict | None,
                          error: bool = False) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or error or not result or \
                self.metric not in result:
            return
        v = float(result[self.metric])
        score = -v if self.mode == "max" else v
        self._obs.append((cfg, score))

    # -- TPE internals --

    def _tpe_suggest(self) -> dict:
        import math
        obs = sorted(self._obs, key=lambda cv: cv[1])
        n_good = max(1, int(len(obs) * self.gamma))
        good, bad = obs[:n_good], obs[n_good:]
        out = {}
        for key, spec in self.param_space.items():
            gvals = [c[key] for c, _ in good if key in c]
            bvals = [c[key] for c, _ in bad if key in c]
            if isinstance(spec, (_Choice, _GridSearch)):
                out[key] = self._categorical(spec, gvals, bvals)
                continue
            if not isinstance(spec, (_Uniform, _LogUniform, _RandInt)):
                out[key] = _sample(spec, self.rng)
                continue
            logspace = isinstance(spec, _LogUniform)
            xform = math.log if logspace else (lambda x: x)
            inv = math.exp if logspace else (lambda x: x)
            lo, hi = xform(spec.low), xform(spec.high)
            g = [xform(v) for v in gvals] or [(lo + hi) / 2]
            b = [xform(v) for v in bvals]
            bw = max((hi - lo) / 8,
                     _std(g) if len(g) > 1 else (hi - lo) / 8)
            best_x, best_ratio = None, -math.inf
            for _ in range(self.n_candidates):
                mu = self.rng.choice(g)
                x = min(hi, max(lo, self.rng.gauss(mu, bw)))
                ratio = _kde(x, g, bw) / max(_kde(x, b, bw), 1e-12)
                if ratio > best_ratio:
                    best_x, best_ratio = x, ratio
            val = inv(best_x)
            if isinstance(spec, _RandInt):
                val = min(spec.high - 1, max(spec.low, round(val)))
            out[key] = val
        return out

    def _categorical(self, spec, gvals, bvals):
        values = list(spec.values)
        gc = {v: 1.0 for v in values}
        bc = {v: 1.0 for v in values}
        for v in gvals:
            gc[v] = gc.get(v, 1.0) + 1
        for v in bvals:
            bc[v] = bc.get(v, 1.0) + 1
        weights = [gc[v] / bc[v] for v in values]
        total = sum(weights)
        r = self.rng.uniform(0, total)
        acc = 0.0
        for v, w in zip(values, weights):
            acc += w
            if r <= acc:
                return v
        return values[-1]


def _std(xs: list[float]) -> float:
    m = sum(xs) / len(xs)
    return (sum((x - m) ** 2 for x in xs) / len(xs)) ** 0.5


def _kde(x: float, xs: list[float], bw: float) -> float:
    import math
    if not xs:
        return 1e-12
    s = sum(math.exp(-0.5 * ((x - m) / bw) ** 2) for m in xs)
    return s / (len(xs) * bw * math.sqrt(2 * math.pi))


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions from the wrapped searcher
    (reference: python/ray/tune/search/concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set[str] = set()

    def suggest(self, trial_id: str) -> dict | None:
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def is_finished(self) -> bool:
        return self.searcher.is_finished()

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        # Forward rung results so wrapped model-based searchers
        # (BOHB) keep learning from partial budgets. Guarded like the
        # Tuner's own hasattr check: a duck-typed searcher that never
        # defined it must not crash the loop.
        fwd = getattr(self.searcher, "on_trial_result", None)
        if callable(fwd):
            fwd(trial_id, result)

    def on_trial_complete(self, trial_id: str, result: dict | None,
                          error: bool = False) -> None:
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error=error)


class BayesOptSearcher(Searcher):
    """Gaussian-process Bayesian optimization with expected
    improvement (reference analog: python/ray/tune/search/bayesopt/ —
    the bayesian-optimization package's GP+EI loop, here numpy-only).

    Continuous dims are normalized to [0, 1] (log-scaled for
    loguniform); integers round; categoricals map to index/num. After
    ``n_startup`` random trials an RBF-kernel GP is fit over all
    observations and the next config maximizes EI over random
    candidates.
    """

    def __init__(self, param_space: dict, metric: str = "loss",
                 mode: str = "min", num_samples: int = 32,
                 n_startup: int = 6, n_candidates: int = 256,
                 length_scale: float = 0.25, noise: float = 1e-4,
                 xi: float = 0.01, seed: int | None = None):
        self.param_space = param_space
        self.metric, self.mode = metric, mode
        self.num_samples = num_samples
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.length_scale = length_scale
        self.noise = noise
        self.xi = xi
        self.rng = random.Random(seed)
        self._n = 0
        self._X: list[list[float]] = []   # normalized configs
        self._y: list[float] = []         # scores (lower = better)
        self._pending: dict[str, dict] = {}
        self._keys = list(param_space.keys())

    # -- [0,1]^d encoding --

    def _encode(self, cfg: dict) -> list[float]:
        import math
        out = []
        for k in self._keys:
            spec, v = self.param_space[k], cfg[k]
            if isinstance(spec, _LogUniform):
                out.append((math.log(v) - math.log(spec.low))
                           / (math.log(spec.high)
                              - math.log(spec.low)))
            elif isinstance(spec, _Uniform):
                out.append((v - spec.low) / (spec.high - spec.low))
            elif isinstance(spec, _RandInt):
                out.append((v - spec.low)
                           / max(1, spec.high - 1 - spec.low))
            elif isinstance(spec, (_Choice, _GridSearch)):
                vals = list(spec.values)
                out.append(vals.index(v) / max(1, len(vals) - 1))
            else:
                out.append(0.0)
        return out

    def _decode(self, x: list[float]) -> dict:
        import math
        cfg = {}
        for k, u in zip(self._keys, x):
            spec = self.param_space[k]
            u = min(1.0, max(0.0, u))
            if isinstance(spec, _LogUniform):
                cfg[k] = math.exp(
                    math.log(spec.low) + u
                    * (math.log(spec.high) - math.log(spec.low)))
            elif isinstance(spec, _Uniform):
                cfg[k] = spec.low + u * (spec.high - spec.low)
            elif isinstance(spec, _RandInt):
                cfg[k] = min(spec.high - 1,
                             spec.low + round(
                                 u * max(1, spec.high - 1 - spec.low)))
            elif isinstance(spec, (_Choice, _GridSearch)):
                vals = list(spec.values)
                cfg[k] = vals[min(len(vals) - 1,
                                  round(u * (len(vals) - 1)))]
            else:
                cfg[k] = _sample(spec, self.rng,
                                 partial_config=cfg)
        return cfg

    def suggest(self, trial_id: str) -> dict | None:
        if self._n >= self.num_samples:
            return None
        self._n += 1
        if len(self._y) < self.n_startup:
            cfg = {k: _sample(v, self.rng)
                   for k, v in self.param_space.items()}
        else:
            cfg = self._decode(self._ei_argmax())
        self._pending[trial_id] = cfg
        return cfg

    def _ei_argmax(self) -> list[float]:
        import numpy as np
        X = np.asarray(self._X)
        y = np.asarray(self._y)
        y_mu, y_sd = y.mean(), max(y.std(), 1e-12)
        yn = (y - y_mu) / y_sd
        ls = self.length_scale

        def rbf(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / ls ** 2)

        K = rbf(X, X) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        cand = np.asarray([
            [self.rng.random() for _ in self._keys]
            for _ in range(self.n_candidates)])
        Ks = rbf(cand, X)                      # (C, N)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)           # (N, C)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        sd = np.sqrt(var)
        best = yn.min()
        z = (best - mu - self.xi) / sd
        # EI for minimization, with normal cdf/pdf via erf.
        from math import erf, pi, sqrt
        cdf = np.asarray([(1 + erf(zi / sqrt(2))) / 2 for zi in z])
        pdf = np.exp(-0.5 * z ** 2) / sqrt(2 * pi)
        ei = (best - mu - self.xi) * cdf + sd * pdf
        return [float(u) for u in cand[int(ei.argmax())]]

    def is_finished(self) -> bool:
        return self._n >= self.num_samples

    def on_trial_complete(self, trial_id: str, result: dict | None,
                          error: bool = False) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or error or not result or \
                self.metric not in result:
            return
        v = float(result[self.metric])
        score = -v if self.mode == "max" else v
        self._X.append(self._encode(cfg))
        self._y.append(score)


class BOHBSearcher(TPESearcher):
    """BOHB's model-based sampling (reference analog:
    python/ray/tune/search/bohb/ TuneBOHB): TPE densities fit on
    observations from the LARGEST budget (training_iteration) that
    has enough of them — pair with :class:`HyperBandScheduler` for
    the full BOHB loop (bracketed successive halving + model-based
    proposals).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._budget_obs: dict[int, list] = {}
        # (budget, score) most recently recorded per trial — the
        # final report reaches us twice (on_trial_result for the last
        # rung, then on_trial_complete with the same metrics) and
        # must not be double-weighted in the densities.
        self._last_recorded: dict[str, tuple] = {}

    def _record(self, trial_id: str, result: dict) -> None:
        cfg = self._pending.get(trial_id)
        if cfg is None or self.metric not in result:
            return
        v = float(result[self.metric])
        score = -v if self.mode == "max" else v
        budget = int(result.get("training_iteration", 1))
        if self._last_recorded.get(trial_id) == (budget, score):
            return
        self._last_recorded[trial_id] = (budget, score)
        self._budget_obs.setdefault(budget, []).append((cfg, score))

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        """Record intermediate rung results keyed by budget (BOHB
        learns from partial evaluations, not only completions)."""
        self._record(trial_id, result)

    def on_trial_complete(self, trial_id: str, result: dict | None,
                          error: bool = False) -> None:
        if not error and result:
            self._record(trial_id, result)
        self._last_recorded.pop(trial_id, None)
        super().on_trial_complete(trial_id, result, error=error)

    def _tpe_suggest(self) -> dict:
        # BOHB rule: model the largest budget with >= n_startup obs.
        for budget in sorted(self._budget_obs, reverse=True):
            obs = self._budget_obs[budget]
            if len(obs) >= self.n_startup:
                saved = self._obs
                self._obs = obs
                try:
                    return super()._tpe_suggest()
                finally:
                    self._obs = saved
        return super()._tpe_suggest()
