"""Classic Tune surface (reference: python/ray/tune/__init__.py):
Trainable class API, Callbacks + CLIReporter, ExperimentAnalysis,
Experiment/run_experiments, create_searcher/create_scheduler,
PlacementGroupFactory, TuneError, ResumeConfig.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable


class TuneError(Exception):
    """(reference: ray.tune.TuneError)"""


# -- Trainable class API (reference: tune/trainable/trainable.py) ----


class Trainable:
    """Subclass API: override ``setup``/``step`` (and optionally
    ``save_checkpoint``/``load_checkpoint``/``cleanup``). Each
    ``step()`` returns a metrics dict; return ``{"done": True, ...}``
    (or rely on a stop condition / scheduler) to finish. A
    ``save_checkpoint`` implementation makes the trial
    PBT-exploitable and resumable."""

    def __init__(self, config: dict | None = None):
        self.config = dict(config or {})
        self._iteration = 0
        self.setup(self.config)

    # -- override points --

    def setup(self, config: dict) -> None:
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str):
        return None

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def cleanup(self) -> None:
        pass

    # -- harness --

    @property
    def iteration(self) -> int:
        return self._iteration

    def train(self) -> dict:
        result = self.step()
        if not isinstance(result, dict):
            raise TuneError(
                f"{type(self).__name__}.step() must return a dict, "
                f"got {type(result).__name__}")
        self._iteration += 1
        result.setdefault("training_iteration", self._iteration)
        return result

    def stop(self) -> None:
        self.cleanup()


def _class_trainable_fn(trainable_cls):
    """Adapt a Trainable subclass to the function-trainable loop the
    trial actors run: step -> (save_checkpoint) -> report, resuming
    from ``restored_checkpoint_dir`` when the controller set one."""

    def run(config):
        import shutil

        from ray_tpu_torch.train import report
        from ray_tpu_torch.train.session import get_checkpoint

        t = trainable_cls(config)
        ckpt = get_checkpoint()
        if ckpt is not None:
            # dict checkpoints round-trip as a pickled file; dir
            # checkpoints hand back the path (both reference forms)
            d = _load_trainable_dict(ckpt.path)
            t.load_checkpoint(d if d is not None else ckpt.path)
            it = _load_trainable_iteration(ckpt.path)
            if it is not None:
                t._iteration = it
        # only pay the per-step checkpoint dance when the subclass
        # actually implements save_checkpoint
        has_ckpt = (trainable_cls.save_checkpoint
                    is not Trainable.save_checkpoint)
        try:
            while True:
                result = t.train()
                checkpoint = None
                tmp_dir = None
                if has_ckpt:
                    tmp_dir = tempfile.mkdtemp(
                        prefix="trainable_ckpt_")
                    saved = t.save_checkpoint(tmp_dir)
                    if saved is None:
                        shutil.rmtree(tmp_dir, ignore_errors=True)
                        tmp_dir = None
                    else:
                        if isinstance(saved, dict):
                            # the reference's other checkpoint form:
                            # persist the dict, hand it back on load
                            _save_trainable_dict(tmp_dir, saved)
                            path = tmp_dir
                        elif isinstance(saved, str):
                            path = saved
                        else:
                            raise TuneError(
                                f"save_checkpoint must return a "
                                f"path, a dict, or None — got "
                                f"{type(saved).__name__}")
                        _save_trainable_iteration(path, t._iteration)
                        from ray_tpu_torch.train.session import Checkpoint
                        checkpoint = Checkpoint(path)
                report(result, checkpoint=checkpoint)
                if tmp_dir is not None:
                    # report() persisted a copy into the trial dir;
                    # the per-step temp must not accumulate
                    shutil.rmtree(tmp_dir, ignore_errors=True)
                if result.get("done"):
                    break
        finally:
            t.stop()

    run.__name__ = trainable_cls.__name__
    return run


def _save_trainable_dict(path: str, state: dict) -> None:
    from ray_tpu_torch.core import serialization as ser
    with open(os.path.join(path, ".trainable_dict_ckpt.pkl"),
              "wb") as f:
        f.write(ser.dumps(state))


def _load_trainable_dict(path: str) -> dict | None:
    from ray_tpu_torch.core import serialization as ser
    try:
        with open(os.path.join(path, ".trainable_dict_ckpt.pkl"),
                  "rb") as f:
            return ser.loads(f.read())
    except OSError:
        return None


def _save_trainable_iteration(path: str, iteration: int) -> None:
    try:
        with open(os.path.join(path, ".trainable_state.json"),
                  "w") as f:
            json.dump({"iteration": iteration}, f)
    except OSError:
        pass


def _load_trainable_iteration(path: str) -> int | None:
    try:
        with open(os.path.join(path, ".trainable_state.json")) as f:
            return json.load(f)["iteration"]
    except (OSError, KeyError, json.JSONDecodeError):
        return None


# -- callbacks (reference: tune/callback.py) -------------------------


class Callback:
    """Controller-side hooks; pass instances via
    ``RunConfig(callbacks=[...])`` or ``tune.run(callbacks=...)``."""

    def on_trial_start(self, iteration: int, trials: list,
                       trial) -> None:
        pass

    def on_trial_result(self, iteration: int, trials: list, trial,
                        result: dict) -> None:
        pass

    def on_trial_complete(self, iteration: int, trials: list,
                          trial) -> None:
        pass

    def on_trial_error(self, iteration: int, trials: list,
                       trial) -> None:
        pass

    def on_experiment_end(self, trials: list, **info) -> None:
        pass


class ProgressReporter(Callback):
    """Reporter ABC (reference: tune/progress_reporter.py) — rebased
    on the Callback seam: reporters ARE result callbacks here."""

    def report(self, trials: list, done: bool) -> None:
        raise NotImplementedError


class CLIReporter(ProgressReporter):
    """Prints a trial-status table on a cadence (reference:
    tune.CLIReporter)."""

    def __init__(self, *, metric_columns: list[str] | None = None,
                 max_report_frequency: float = 5.0):
        self.metric_columns = metric_columns
        self.max_report_frequency = max_report_frequency
        self._last = 0.0

    def report(self, trials: list, done: bool) -> None:
        counts: dict[str, int] = {}
        for t in trials:
            counts[t.state] = counts.get(t.state, 0) + 1
        head = (f"== Status == {len(trials)} trials: "
                + ", ".join(f"{k}={v}" for k, v in sorted(
                    counts.items())))
        rows = [head]
        cols = self.metric_columns
        for t in trials:
            metrics = t.metrics or {}
            shown = {k: metrics.get(k) for k in cols} if cols \
                else metrics
            rows.append(f"  {t.trial_id}  {t.state:<10} "
                        f"iter={t.iteration}  {shown}")
        print("\n".join(rows), flush=True)

    def _maybe(self, trials, done=False):
        now = time.monotonic()
        if done or now - self._last >= self.max_report_frequency:
            self._last = now
            self.report(trials, done)

    def on_trial_result(self, iteration, trials, trial, result):
        self._maybe(trials)

    def on_experiment_end(self, trials, **info):
        self._maybe(trials, done=True)


# -- ExperimentAnalysis (reference: tune/analysis/experiment_analysis.py)


class ExperimentAnalysis:
    """Reads a finished (or mid-run) experiment's journal
    (``experiment_state.json``, the file Tuner journals) and answers
    best-trial questions without the Tuner object."""

    def __init__(self, experiment_dir: str,
                 default_metric: str | None = None,
                 default_mode: str | None = None):
        path = experiment_dir
        if os.path.isdir(path):
            path = os.path.join(path, "experiment_state.json")
        if not os.path.exists(path):
            raise ValueError(f"no experiment journal at {path!r}")
        with open(path) as f:
            self._state = json.load(f)
        self._dir = os.path.dirname(path)
        self.default_metric = default_metric
        self.default_mode = default_mode

    @property
    def trials(self) -> list[dict]:
        return list(self._state.get("trials", []))

    def _metric_mode(self, metric, mode):
        metric = metric or self.default_metric
        mode = mode or self.default_mode or "min"
        if metric is None:
            raise ValueError("pass metric= (or default_metric)")
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        return metric, mode

    def get_best_trial(self, metric: str | None = None,
                       mode: str | None = None) -> dict:
        metric, mode = self._metric_mode(metric, mode)
        scored = [t for t in self.trials
                  if metric in (t.get("metrics") or {})]
        if not scored:
            raise ValueError(f"no trial reported {metric!r}")
        pick = min if mode == "min" else max
        return pick(scored, key=lambda t: t["metrics"][metric])

    def get_best_config(self, metric: str | None = None,
                        mode: str | None = None) -> dict:
        return self.get_best_trial(metric, mode)["config"]

    def get_best_checkpoint(self, metric: str | None = None,
                            mode: str | None = None) -> str | None:
        ckpt = self.get_best_trial(metric, mode).get("checkpoint_dir")
        if ckpt and not os.path.isabs(ckpt):
            ckpt = os.path.join(self._dir, ckpt)
        return ckpt

    @property
    def best_config(self) -> dict:
        return self.get_best_config()

    def dataframe(self):
        """Final metrics per trial as a pandas DataFrame."""
        import pandas as pd
        rows = []
        for t in self.trials:
            row = {"trial_id": t["trial_id"], "state": t["state"]}
            row.update({f"config/{k}": v
                        for k, v in (t.get("config") or {}).items()})
            row.update(t.get("metrics") or {})
            rows.append(row)
        return pd.DataFrame(rows)


# -- factories (reference: tune/search/__init__.py create_searcher /
#    tune/schedulers/__init__.py create_scheduler) -------------------


def create_searcher(search_alg: str, **kwargs):
    from ray_tpu_torch.tune.optuna import OptunaSearch
    from ray_tpu_torch.tune.search import (
        BasicVariantGenerator,
        BayesOptSearcher,
        BOHBSearcher,
        RandomSearcher,
        TPESearcher,
    )
    table = {
        "variant_generator": BasicVariantGenerator,
        "random": RandomSearcher,
        "tpe": TPESearcher,
        "hyperopt": TPESearcher,     # TPE is hyperopt's algorithm
        "bayesopt": BayesOptSearcher,
        "bohb": BOHBSearcher,
        "optuna": OptunaSearch,
    }
    if search_alg not in table:
        raise ValueError(
            f"unknown searcher {search_alg!r}; one of {sorted(table)}")
    return table[search_alg](**kwargs)


def create_scheduler(scheduler: str, **kwargs):
    from ray_tpu_torch.tune.pb2 import PB2
    from ray_tpu_torch.tune.schedulers import (
        ASHAScheduler,
        FIFOScheduler,
        HyperBandScheduler,
        MedianStoppingRule,
        PopulationBasedTraining,
    )
    table = {
        "fifo": FIFOScheduler,
        "asha": ASHAScheduler,
        "async_hyperband": ASHAScheduler,
        "hyperband": HyperBandScheduler,
        "median_stopping_rule": MedianStoppingRule,
        "pbt": PopulationBasedTraining,
        "pb2": PB2,
    }
    if scheduler not in table:
        raise ValueError(
            f"unknown scheduler {scheduler!r}; one of "
            f"{sorted(table)}")
    return table[scheduler](**kwargs)


# -- resources (reference: tune/execution/placement_groups.py) -------


class PlacementGroupFactory:
    """Trial resource spec as PG bundles (reference:
    tune.PlacementGroupFactory). Trials here run as single actors, so
    the factory's bundles merge into one per-trial resource demand —
    the summed shape a PG would have reserved."""

    def __init__(self, bundles: list[dict], strategy: str = "PACK"):
        if not bundles:
            raise ValueError("need at least one bundle")
        self.bundles = [dict(b) for b in bundles]
        self.strategy = strategy

    @property
    def required_resources(self) -> dict:
        out: dict[str, float] = {}
        for b in self.bundles:
            for k, v in b.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def __repr__(self):
        return (f"PlacementGroupFactory({self.bundles}, "
                f"{self.strategy})")


# -- Experiment / run_experiments (reference: tune/experiment/) ------


@dataclass
class Experiment:
    name: str
    run: Any                      # trainable (fn / class / name)
    config: dict = field(default_factory=dict)
    num_samples: int = 1
    stop: Any = None
    storage_path: str | None = None
    metric: str | None = None
    mode: str | None = None


def run_experiments(experiments, **kwargs) -> dict:
    """Run one or more experiment specs (reference:
    tune.run_experiments). Accepts an Experiment, a list of them, or
    the classic ``{name: spec_dict}`` mapping; returns
    {name: ResultGrid}."""
    from ray_tpu_torch.tune import compat as tune_compat

    specs: list[Experiment] = []
    if isinstance(experiments, Experiment):
        specs = [experiments]
    elif isinstance(experiments, dict):
        for name, spec in experiments.items():
            spec = dict(spec)
            specs.append(Experiment(
                name=name,
                run=spec.pop("run"),
                config=spec.pop("config", {}),
                num_samples=spec.pop("num_samples", 1),
                stop=spec.pop("stop", None),
                storage_path=spec.pop("storage_path", None),
                metric=spec.pop("metric", None),
                mode=spec.pop("mode", None)))
            if spec:
                raise TuneError(
                    f"experiment {name!r}: unsupported spec keys "
                    f"{sorted(spec)}")
    else:
        specs = list(experiments)
    out = {}
    for e in specs:
        out[e.name] = tune_compat.run(
            e.run, config=e.config, num_samples=e.num_samples,
            stop=e.stop, storage_path=e.storage_path, name=e.name,
            metric=e.metric, mode=e.mode, **kwargs)
    return out


@dataclass
class ResumeConfig:
    """(reference: tune.ResumeConfig) Controls which trial states
    re-run on Tuner.restore."""

    resume_errored: bool = True
    restart_errored: bool = False
