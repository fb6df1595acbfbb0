"""Optuna searcher adapter (reference:
``python/ray/tune/search/optuna/optuna_search.py`` — OptunaSearch
wrapping an optuna study's ask/tell protocol behind the Searcher
interface).

The seam: ray_tpu_torch.tune's internal searchers (TPE/BayesOpt/...) share
the ``Searcher`` ABC; this adapter proves external suggestion
libraries plug into the same slot. optuna itself is a SOFT dependency
— absent in this build image — so the study is injectable: production
passes nothing (optuna.create_study is used), tests pass a mock study
and exercise the full ask/tell round-trip without the package.
"""

from __future__ import annotations

from typing import Any, Callable

from ray_tpu_torch.tune.search import (
    Searcher,
    _Choice,
    _GridSearch,
    _LogUniform,
    _RandInt,
    _Uniform,
)

__all__ = ["OptunaSearch"]


class OptunaSearch(Searcher):
    """Drive trials from an optuna study.

    ``space``: a ray_tpu_torch.tune param_space dict (choice/uniform/
    loguniform/randint/grid_search values; constants pass through) —
    translated to ``trial.suggest_*`` calls — or a define-by-run
    callable ``(trial) -> dict`` for conditional spaces.
    ``study``: injectable pre-built study (tests; pre-seeded studies;
    storage-backed studies). Without it optuna is imported and a
    fresh in-memory study is created.
    """

    def __init__(self, space: dict | Callable | None = None,
                 metric: str = "loss", mode: str = "min",
                 num_samples: int = 16,
                 study: Any = None, sampler: Any = None,
                 seed: int | None = None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        if space is None:
            raise ValueError("OptunaSearch needs a param space (dict "
                             "of tune sample primitives or a "
                             "define-by-run callable)")
        self._space = space
        self._metric = metric
        self._mode = mode
        if study is None:
            try:
                import optuna
            except ImportError as e:
                raise ImportError(
                    "OptunaSearch without an injected study needs the "
                    "'optuna' package (pip install optuna), or pass "
                    "study=<your study-compatible object>") from e
            sampler = sampler or optuna.samplers.TPESampler(seed=seed)
            study = optuna.create_study(
                direction=("minimize" if mode == "min"
                           else "maximize"),
                sampler=sampler)
        self._study = study
        self._trials: dict[str, Any] = {}
        self._num_samples = num_samples
        self._asked = 0

    # -- Searcher interface --

    def is_finished(self) -> bool:
        return self._asked >= self._num_samples

    def suggest(self, trial_id: str) -> dict | None:
        if self.is_finished():
            return None
        self._asked += 1
        trial = self._study.ask()
        if callable(self._space) and not isinstance(self._space, dict):
            params = self._space(trial)
            if params is None:
                params = dict(trial.params)
        else:
            params = {k: self._suggest_param(trial, k, spec)
                      for k, spec in self._space.items()}
        self._trials[trial_id] = trial
        return params

    @staticmethod
    def _suggest_param(trial, name: str, spec):
        if isinstance(spec, _Choice):
            return trial.suggest_categorical(name, list(spec.values))
        if isinstance(spec, _GridSearch):
            # optuna has no grid primitive at the trial API level;
            # categorical + the sampler covers the axis.
            return trial.suggest_categorical(name, list(spec.values))
        if isinstance(spec, _LogUniform):
            return trial.suggest_float(name, spec.low, spec.high,
                                       log=True)
        if isinstance(spec, _Uniform):
            return trial.suggest_float(name, spec.low, spec.high)
        if isinstance(spec, _RandInt):
            return trial.suggest_int(name, spec.low, spec.high - 1)
        return spec                    # constant: pass through

    def on_trial_complete(self, trial_id: str, result: dict | None,
                          error: bool = False) -> None:
        trial = self._trials.pop(trial_id, None)
        if trial is None:
            return
        if error or result is None or self._metric not in result:
            self._study.tell(trial, None, state=self._fail_state())
            return
        self._study.tell(trial, float(result[self._metric]))

    @staticmethod
    def _fail_state():
        try:
            import optuna
            return optuna.trial.TrialState.FAIL
        except ImportError:
            return "FAIL"              # mock studies take the string

    def best_params(self) -> dict:
        return dict(self._study.best_params)
