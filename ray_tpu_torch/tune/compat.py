"""Classic-API compatibility surface for Tune.

The reference keeps two generations of its API alive — the modern
``Tuner`` and the classic ``tune.run`` family — and real user code
switching over calls the classic names. Each shim here delegates to
the modern machinery with real behavior (no stubs):

- ``tune.run(trainable, config=..., num_samples=..., ...)`` wraps a
  ``Tuner`` and returns its ``ResultGrid`` (reference:
  python/ray/tune/tune.py:267).
- ``with_parameters(fn, **large)`` binds large objects through the
  object store, one put per object shared by every trial (reference:
  tune.with_parameters).
- ``with_resources(fn, {...})`` attaches a per-trial resource
  request consumed by the controller's trial actors.
- ``register_trainable(name, fn)`` + name-based ``run``/``Tuner``
  lookup (reference: tune.register_trainable).
- ``Stopper`` ABC + ``MaximumIterationStopper``/
  ``TrialPlateauStopper`` consumed via ``RunConfig.stop`` (callable
  or Stopper) at every result boundary.
"""

from __future__ import annotations

from typing import Any, Callable

_REGISTRY: dict[str, Callable] = {}


def register_trainable(name: str, trainable: Callable) -> None:
    if not callable(trainable):
        raise TypeError("trainable must be callable")
    _REGISTRY[name] = trainable


def get_trainable(name_or_fn):
    if isinstance(name_or_fn, str):
        try:
            return _REGISTRY[name_or_fn]
        except KeyError:
            raise ValueError(
                f"unknown trainable {name_or_fn!r}; "
                f"register_trainable() it first "
                f"(registered: {sorted(_REGISTRY)})") from None
    return name_or_fn


def with_parameters(trainable: Callable, **large_objects):
    """Bind large constant objects to a trainable through the object
    store: ONE ray_tpu_torch.put per object, every trial gets() the shared
    copy instead of re-pickling it into each trial's closure."""
    import ray_tpu_torch

    refs = {k: ray_tpu_torch.put(v) for k, v in large_objects.items()}

    def wrapped(config):
        bound = {k: ray_tpu_torch.get(r) for k, r in refs.items()}
        return trainable(config, **bound)

    wrapped.__name__ = getattr(trainable, "__name__", "trainable")
    # Keep the refs alive as long as the wrapped trainable exists.
    wrapped._bound_refs = refs
    return wrapped


def with_resources(trainable: Callable, resources):
    """Attach a per-trial resource request — a plain dict or a
    tune.PlacementGroupFactory (consumed by the controller when it
    creates trial actors)."""
    from ray_tpu_torch.tune.classic import PlacementGroupFactory
    if isinstance(resources, PlacementGroupFactory):
        resources = resources.required_resources
    fn = get_trainable(trainable)

    def wrapped(config):
        return fn(config)

    wrapped.__name__ = getattr(fn, "__name__", "trainable")
    wrapped._tune_resources = dict(resources)
    return wrapped


class Stopper:
    """Decides per-result whether a trial (and optionally the whole
    experiment) should stop (reference: tune.Stopper)."""

    def __call__(self, trial_id: str, result: dict) -> bool:
        raise NotImplementedError

    def stop_all(self) -> bool:
        return False


class MaximumIterationStopper(Stopper):
    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._iters: dict[str, int] = {}

    def __call__(self, trial_id: str, result: dict) -> bool:
        self._iters[trial_id] = self._iters.get(trial_id, 0) + 1
        return self._iters[trial_id] >= self.max_iter


class TrialPlateauStopper(Stopper):
    """Stop a trial when its metric stops improving: std of the last
    ``num_results`` values at or below ``std`` (reference:
    tune.stopper.TrialPlateauStopper)."""

    def __init__(self, metric: str, std: float = 0.01,
                 num_results: int = 4, grace_period: int = 4):
        self.metric = metric
        self.std = std
        self.num_results = num_results
        self.grace = grace_period
        self._hist: dict[str, list[float]] = {}

    def __call__(self, trial_id: str, result: dict) -> bool:
        if self.metric not in result:
            return False
        h = self._hist.setdefault(trial_id, [])
        h.append(float(result[self.metric]))
        if len(h) < max(self.grace, self.num_results):
            return False
        window = h[-self.num_results:]
        mean = sum(window) / len(window)
        var = sum((x - mean) ** 2 for x in window) / len(window)
        return var ** 0.5 <= self.std


def run(trainable, *, config: dict | None = None,
        num_samples: int = 1, metric: str | None = None,
        mode: str | None = None, scheduler=None, search_alg=None,
        stop=None, storage_path: str | None = None,
        name: str | None = None, max_concurrent_trials: int = 0,
        callbacks: list | None = None,
        progress_reporter=None,
        resources_per_trial=None,
        resume: bool = False,
        **ignored: Any):
    """Classic entry point: builds a Tuner and fits it. Unknown
    keyword arguments are rejected loudly rather than silently
    dropped — a switcher must learn what differs, not get wrong
    behavior."""
    if ignored:
        raise TypeError(
            f"tune.run: unsupported arguments {sorted(ignored)}; "
            f"use the Tuner API for anything beyond the classic "
            f"surface")
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.tune.classic import Trainable
    from ray_tpu_torch.tune.tune import TuneConfig, Tuner

    if isinstance(trainable, type) and issubclass(trainable,
                                                  Trainable):
        from ray_tpu_torch.tune.classic import _class_trainable_fn
        fn = _class_trainable_fn(trainable)
    else:
        fn = get_trainable(trainable)
    if resources_per_trial is not None:
        fn = with_resources(fn, resources_per_trial)
    cbs = list(callbacks or [])
    if progress_reporter is not None:
        cbs.append(progress_reporter)   # reporters ARE callbacks here
    tc = TuneConfig(
        num_samples=num_samples, metric=metric,
        mode=mode or "min",
        scheduler=scheduler, search_alg=search_alg,
        max_concurrent_trials=max_concurrent_trials,
        stop=stop)
    rc_kwargs = {}
    if storage_path:
        rc_kwargs["storage_path"] = storage_path
    if name:
        rc_kwargs["name"] = name
    if cbs:
        rc_kwargs["callbacks"] = cbs
    if resume:
        # classic tune.run(resume=True): continue the named
        # experiment from its journal — with the SAME wrapped
        # trainable and tune settings as the original call (resources
        # wrap and TuneConfig built above). Loud contract: what
        # restore cannot carry is rejected, not dropped.
        import os as _os

        from ray_tpu_torch.util.storage import is_uri
        if not (name and storage_path):
            raise ValueError(
                "tune.run(resume=True) needs name= and storage_path= "
                "to locate the experiment journal")
        if cbs:
            raise ValueError(
                "tune.run(resume=True) does not carry callbacks/"
                "progress_reporter through restore; use the Tuner "
                "API or drop them")
        if is_uri(storage_path):
            exp_dir = storage_path.rstrip("/") + "/" + name
        else:
            exp_dir = _os.path.join(storage_path, name)
            if not _os.path.exists(
                    _os.path.join(exp_dir, "experiment_state.json")):
                raise ValueError(
                    f"resume=True but no journal at {exp_dir!r}")
        return Tuner.restore(exp_dir, fn, tune_config=tc).fit()
    tuner = Tuner(
        fn,
        param_space=config or {},
        tune_config=tc,
        run_config=RunConfig(**rc_kwargs) if rc_kwargs else None,
    )
    return tuner.fit()
