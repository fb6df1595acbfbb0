"""Tuner + trial controller: the counterpart of ``ray_tpu/tune/tune.py``.

Reference call stack being re-based (SURVEY.md §3.4 / §2.3 Tune):
``Tuner.fit`` → controller event loop managing trials as actors
(python/ray/tune/execution/tune_controller.py:68). A trial is one
TrainWorker-style actor (function trainables), or a whole TorchTrainer
(its gang nests through the core runtime — actors creating actors).
A trial that asks for a share of a card (``resources_per_trial={"GPU":
0.5}``) runs in an actor that sees that card and no other; one that asks
for none sees no card, so its CUDA calls fail rather than train on the
CPU. The default concurrency is bounded by every resource a trial asks
for, the card's share too (the JAX module bounds it by CPUs alone).
Schedulers act at result boundaries: ASHA/HyperBand/median-stop kill
the trial actor; PBT restarts it from a donor's checkpoint with a
mutated config (EXPLOIT). Experiment state is journaled to
``<exp_dir>/experiment_state.json`` after every controller step so
``Tuner.restore`` can resume an interrupted run (reference:
python/ray/tune/execution/experiment_state.py).
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch.core.config import temp_path
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.worker_group import TrainWorker
from ray_tpu_torch.tune.schedulers import (
    CONTINUE, EXPLOIT, STOP, FIFOScheduler,
)
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher


def _stop_requested(stop, trial_id: str, result: dict) -> bool:
    """TuneConfig.stop in its three classic forms (Stopper /
    callable / {metric: threshold})."""
    if stop is None:
        return False
    if isinstance(stop, dict):
        return any(k in result and result[k] >= v
                   for k, v in stop.items())
    return bool(stop(trial_id, result))


@dataclass
class TuneConfig:
    num_samples: int = 1
    max_concurrent_trials: int = 0      # 0 = resource-bound
    metric: str | None = None
    mode: str = "min"
    scheduler: Any = None               # FIFO/ASHA/HyperBand/PBT/...
    search_alg: Searcher | None = None
    resources_per_trial: dict[str, float] = field(
        default_factory=lambda: {"CPU": 1.0})
    seed: int | None = None
    # Per-result stop condition: a tune.Stopper, a callable
    # (trial_id, result) -> bool, or a dict {metric: threshold}
    # (stop when result[metric] >= threshold — classic tune.run
    # semantics).
    stop: Any = None
    # Wall-clock budget for the WHOLE experiment (reference:
    # TuneConfig.time_budget_s): once exceeded, no new trials are
    # admitted and running trials are stopped at their next result.
    time_budget_s: float | None = None


@dataclass
class TrialResult:
    trial_id: str
    config: dict
    metrics: dict
    metrics_history: list[dict]
    checkpoint_dir: str | None
    state: str
    error: str | None = None


@dataclass
class Trial:
    trial_id: str
    config: dict
    state: str = "PENDING"   # PENDING/RUNNING/COMPLETED/STOPPED/ERROR
    actor: Any = None
    iteration: int = 0
    metrics: dict = field(default_factory=dict)
    history: list = field(default_factory=list)
    checkpoint_dir: str | None = None
    error: str | None = None
    restore_from: str | None = None     # PBT exploit checkpoint
    perturbations: int = 0
    failures: int = 0        # FailureConfig.max_failures retries used


class ResultGrid:
    def __init__(self, results: list[TrialResult]):
        self._results = results

    def __len__(self):
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i):
        return self._results[i]

    def get_best_result(self, metric: str, mode: str = "min"
                        ) -> TrialResult:
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return (min if mode == "min" else max)(scored, key=key)

    @property
    def errors(self) -> list[TrialResult]:
        return [r for r in self._results if r.state == "ERROR"]


class Tuner:
    def __init__(self, trainable: Callable | Any,
                 *,
                 param_space: dict | None = None,
                 tune_config: TuneConfig | None = None,
                 run_config: RunConfig | None = None,
                 _restore_trials: list[Trial] | None = None,
                 _restore_exp_dir: str | None = None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restore_trials = _restore_trials
        # Restored experiments keep their original (possibly remote)
        # exp_dir semantics: a URI restore must re-mirror back to the
        # SAME remote location under the SAME name.
        self._restore_exp_dir = _restore_exp_dir

    @classmethod
    def restore(cls, exp_dir: str, trainable: Callable | Any,
                *, tune_config: TuneConfig | None = None,
                resume_config=None) -> "Tuner":
        """Resume an interrupted experiment from its journaled state:
        completed trials keep their results; pending/running/errored
        trials are re-run (from their latest checkpoint when the
        trainable consumes ``restored_checkpoint_dir``).
        ``resume_config`` (tune.ResumeConfig) refines errored-trial
        handling: resume_errored=False keeps them as terminal ERROR
        results; restart_errored=True re-runs them from scratch
        (checkpoint dropped) instead of from their last checkpoint."""
        from ray_tpu_torch.util.storage import is_uri, storage_for_uri
        orig_exp_dir = exp_dir
        if is_uri(exp_dir):
            # Restore from a mirrored experiment: download the tree
            # into a staging dir and resume from there. The resumed
            # fit() re-mirrors to the SAME remote exp dir.
            import tempfile
            staging = tempfile.mkdtemp(prefix="tune_restore_")
            storage_for_uri(exp_dir).download_dir(exp_dir, staging)
            local_dir = staging
        else:
            local_dir = exp_dir
        state_file = os.path.join(local_dir, "experiment_state.json")
        with open(state_file) as f:
            state = json.load(f)
        exp_name = state.get("name") or os.path.basename(
            orig_exp_dir.rstrip("/"))
        trials = []
        for row in state["trials"]:
            ckpt = row["checkpoint_dir"]
            if ckpt and not os.path.isabs(ckpt):
                # Journals store checkpoint dirs RELATIVE to exp_dir
                # so a mirrored experiment restores on any host:
                # rebase onto the downloaded tree.
                ckpt = os.path.join(local_dir, ckpt)
            if ckpt and not os.path.isdir(ckpt):
                ckpt = None      # checkpoint not in the mirror:
                #                  the trial restarts from scratch
            t = Trial(trial_id=row["trial_id"], config=row["config"],
                      state=row["state"], metrics=row["metrics"],
                      history=row["history"],
                      checkpoint_dir=ckpt,
                      error=row["error"],
                      failures=int(row.get("failures", 0)))
            was_error = t.state == "ERROR"
            resume_errored = (resume_config is None
                              or getattr(resume_config,
                                         "resume_errored", True))
            restart_errored = getattr(resume_config,
                                      "restart_errored", False)
            if t.state != "COMPLETED" and (
                    not was_error or resume_errored
                    or restart_errored):
                t.state = "PENDING"
                t.restore_from = (None if (was_error
                                           and restart_errored)
                                  else t.checkpoint_dir)
                t.metrics, t.history, t.error = {}, [], None
            trials.append(t)
        run_config = RunConfig(
            name=exp_name,
            storage_path=(os.path.dirname(orig_exp_dir.rstrip("/"))
                          if not is_uri(orig_exp_dir) else
                          orig_exp_dir.rsplit("/", 1)[0]))
        return cls(trainable, tune_config=tune_config,
                   run_config=run_config, _restore_trials=trials,
                   _restore_exp_dir=local_dir)

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        scheduler = tc.scheduler or FIFOScheduler()

        exp_name = self.run_config.name or f"tune_{int(time.time())}"
        from ray_tpu_torch.util.storage import is_uri
        remote_uri = None
        if is_uri(self.run_config.storage_path):
            # URI storage_path: run against a unique local staging
            # dir, mirror the whole experiment tree (journal, trial
            # dirs, checkpoints) to the URI at fit() exit, and the
            # (small) journal on EVERY save so an interrupted run is
            # restorable from the remote — same stage-then-upload
            # flow as TorchTrainer (reference: StorageContext).
            from ray_tpu_torch.util.storage import stage_dir, uri_join
            remote_uri = uri_join(self.run_config.storage_path,
                                  exp_name)
            exp_dir = (self._restore_exp_dir
                       or stage_dir(
                           temp_path("ray_tpu_torch_tune_staging"),
                           exp_name))
        else:
            exp_dir = os.path.join(self.run_config.storage_path,
                                   exp_name)
        os.makedirs(exp_dir, exist_ok=True)
        self._exp_name = exp_name
        self._remote_uri = remote_uri

        fn = _as_function_trainable(self.trainable)
        max_conc = (tc.max_concurrent_trials
                    or self._resource_bound(tc, fn))

        trials: list[Trial] = []
        pending: list[Trial] = []
        if self._restore_trials is not None:
            trials = self._restore_trials
            pending = [t for t in trials if t.state == "PENDING"]
            searcher: Searcher | None = None
        else:
            searcher = tc.search_alg or BasicVariantGenerator(
                self.param_space, tc.num_samples, seed=tc.seed)
        # AFTER the restore rebinding: callbacks must see the real
        # trial list, not the pre-restore empty one.
        self._trials = trials

        running: list[Trial] = []
        exhausted = False   # fallback for searchers that never
        #                     override is_finished()

        def searcher_drained() -> bool:
            return (searcher is None or exhausted
                    or searcher.is_finished())

        budget_t0 = time.monotonic()

        def budget_spent() -> bool:
            return (tc.time_budget_s is not None
                    and time.monotonic() - budget_t0
                    >= tc.time_budget_s)

        while True:
            if budget_spent():
                # time_budget_s: admit nothing further; running
                # trials stop THROUGH the normal poll path (queued
                # results and checkpoints drain before the kill).
                self._budget_exhausted = True
                for t in pending:
                    t.state = "STOPPED"   # terminal, never admitted
                pending.clear()
                exhausted = True
            # Admit: restored pending trials first, then fresh
            # suggestions — lazily, so ConcurrencyLimiter-style
            # searchers see live trial counts.
            while pending and len(running) < max_conc:
                t = pending.pop(0)
                self._start_trial(t, fn, exp_dir, tc, scheduler)
                running.append(t)
            while (searcher is not None and not searcher_drained()
                   and len(running) < max_conc):
                tid = f"trial_{len(trials):05d}_{uuid.uuid4().hex[:6]}"
                cfg = searcher.suggest(tid)
                if cfg is None:
                    # Limiter holding back (re-poll later) — unless
                    # nothing is in flight, in which case no progress
                    # is possible and the searcher is exhausted.
                    if not running and not pending:
                        exhausted = True
                    break
                t = Trial(trial_id=tid, config=cfg)
                trials.append(t)
                self._start_trial(t, fn, exp_dir, tc, scheduler)
                running.append(t)
            if not running and not pending and searcher_drained():
                break
            time.sleep(0.05)
            still = []
            changed = False
            for t in running:
                alive, trial_changed = self._poll_trial(
                    t, fn, exp_dir, tc, scheduler, searcher)
                changed = changed or trial_changed
                if alive:
                    still.append(t)
            running = still
            # Journal only on actual progress — rewriting the full
            # experiment state every 50 ms poll would thrash the disk.
            if changed:
                self._save_state(exp_dir, trials)

        self._save_state(exp_dir, trials)
        self._cb("on_experiment_end", None)
        results = [TrialResult(
            trial_id=t.trial_id, config=t.config, metrics=t.metrics,
            metrics_history=t.history, checkpoint_dir=t.checkpoint_dir,
            state=t.state, error=t.error) for t in trials]
        if remote_uri is not None:
            from ray_tpu_torch.util.storage import mirror_dir
            err = mirror_dir(exp_dir, remote_uri)
            if err:
                import warnings
                warnings.warn(f"tune experiment {exp_name!r}: {err}")
        return ResultGrid(results)

    # -- internals --

    def _cb(self, hook: str, trial, result: dict | None = None) -> None:
        """Invoke tune.Callback hooks (reference: tune/callback.py);
        a raising callback must not take the controller down."""
        cbs = getattr(self.run_config, "callbacks", None) or []
        if not cbs:
            return
        it = getattr(self, "_cb_iteration", 0) + 1
        self._cb_iteration = it
        trials = getattr(self, "_trials", [])
        for cb in cbs:
            fn = getattr(cb, hook, None)
            if fn is None:
                continue
            try:
                if hook == "on_trial_result":
                    fn(it, trials, trial, result)
                elif hook == "on_experiment_end":
                    fn(trials)
                else:
                    fn(it, trials, trial)
            except Exception as e:  # noqa: BLE001
                import warnings
                warnings.warn(f"tune callback {hook} raised: {e!r}")

    def _resource_bound(self, tc: TuneConfig, fn=None) -> int:
        """How many trials fit the cluster at once: the least, over every
        resource a trial asks for, of the cluster's total over the
        trial's need. A trial admitted beyond it would wait for its
        resources and never answer its poll."""
        total = ray_tpu_torch.cluster_resources()
        res = (getattr(fn, "_tune_resources", None)
               or tc.resources_per_trial)
        need = {"CPU": res.get("CPU", 1.0) or 1.0}
        need.update({k: v for k, v in res.items() if k != "CPU" and v})
        return max(1, min(int(total.get(k, 0.0) // v + 1e-9)
                          for k, v in need.items()))

    def _save_state(self, exp_dir: str, trials: list[Trial]) -> None:
        def rel_ckpt(p):
            # Relative-to-exp_dir checkpoint paths make the journal
            # portable: a mirrored experiment restores on any host
            # by rebasing onto the downloaded tree.
            if p and os.path.isabs(p):
                r = os.path.relpath(p, exp_dir)
                return r if not r.startswith("..") else p
            return p

        state = {"name": getattr(self, "_exp_name", None),
                 "trials": [
            {"trial_id": t.trial_id, "config": t.config,
             "state": t.state, "metrics": t.metrics,
             "history": t.history,
             "checkpoint_dir": rel_ckpt(t.checkpoint_dir),
             "error": t.error,
             "failures": t.failures} for t in trials]}
        tmp = os.path.join(exp_dir, ".experiment_state.tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(state, f, default=str)
            os.replace(tmp,
                       os.path.join(exp_dir, "experiment_state.json"))
        except (OSError, TypeError):
            return   # non-serializable config — resume unsupported
        remote = getattr(self, "_remote_uri", None)
        if remote is not None:
            # Journal mirrors on EVERY save (it is small): an
            # interrupted URI run stays restorable from the remote.
            from ray_tpu_torch.util.storage import storage_for_uri, uri_join
            try:
                with open(os.path.join(
                        exp_dir, "experiment_state.json"), "rb") as f:
                    storage_for_uri(remote).write_bytes(
                        uri_join(remote, "experiment_state.json"),
                        f.read())
            except Exception:  # noqa: BLE001 — best-effort mid-run
                pass

    def _start_trial(self, t: Trial, fn, exp_dir: str,
                     tc: TuneConfig, scheduler) -> None:
        trial_dir = os.path.join(exp_dir, t.trial_id)
        os.makedirs(trial_dir, exist_ok=True)
        if hasattr(scheduler, "on_trial_add"):
            scheduler.on_trial_add(t.trial_id, t.config)
        res = (getattr(fn, "_tune_resources", None)
               or tc.resources_per_trial)
        t.actor = TrainWorker.options(
            num_cpus=res.get("CPU", 1.0),
            resources={k: v for k, v in res.items()
                       if k != "CPU"},
        ).remote(0, 1, {})
        ctx_kwargs = {
            "experiment_name": getattr(self, "_exp_name",
                                       os.path.basename(exp_dir)),
            "storage_path": self.run_config.storage_path,
            "trial_dir": trial_dir,
            "restored_checkpoint_dir": t.restore_from,
        }
        t.state = "RUNNING"
        t.actor.start_loop.remote((fn, t.config), ctx_kwargs)
        self._cb("on_trial_start", t)

    def _poll_trial(self, t: Trial, fn, exp_dir: str, tc: TuneConfig,
                    scheduler, searcher) -> tuple[bool, bool]:
        """Poll one trial; returns (still_running, state_changed)."""
        try:
            p = ray_tpu_torch.get(t.actor.poll.remote(), timeout=60)
            if p["done"]:
                # poll() caps each drain (16) AND reads the done flag
                # AFTER draining — a report landing in that window
                # leaves a queued result behind even when this batch
                # came back empty. On done, drain unconditionally
                # until an empty batch: the final metrics must be the
                # LAST report (caught by the 20-iteration
                # class-trainable test + review).
                while True:
                    extra = ray_tpu_torch.get(t.actor.poll.remote(),
                                        timeout=60)
                    if not extra["results"]:
                        break
                    p["results"].extend(extra["results"])
        except Exception as e:  # noqa: BLE001 — actor died
            if self._maybe_retry_trial(t, str(e), fn, exp_dir, tc,
                                       scheduler):
                return True, True
            t.state = "ERROR"
            t.error = str(e)
            if searcher:
                searcher.on_trial_complete(t.trial_id, None, error=True)
            self._cb("on_trial_error", t)
            return False, True
        decision = CONTINUE
        for r in p["results"]:
            t.iteration += 1
            m = dict(r["metrics"])
            m.setdefault("training_iteration", t.iteration)
            t.metrics = m
            t.history.append(m)
            self._cb("on_trial_result", t, result=m)
            if r["checkpoint_dir"]:
                t.checkpoint_dir = r["checkpoint_dir"]
                if hasattr(scheduler, "on_checkpoint"):
                    scheduler.on_checkpoint(t.trial_id,
                                            r["checkpoint_dir"])
            if hasattr(searcher, "on_trial_result"):
                # Model-based searchers (BOHB) learn from partial
                # rung results, not only completions.
                searcher.on_trial_result(t.trial_id, m)
            decision = scheduler.on_result(t.trial_id, m)
            if decision not in (STOP, EXPLOIT) and \
                    _stop_requested(tc.stop, t.trial_id, m):
                decision = STOP
            if decision in (STOP, EXPLOIT):
                break
        changed = bool(p["results"])
        if getattr(self, "_budget_exhausted", False) \
                and decision not in (STOP, EXPLOIT):
            # time_budget_s spent: force the normal STOP path (the
            # results above were already drained and recorded)
            decision = STOP
        if decision == EXPLOIT and not p["done"]:
            # PBT: restart this trial from a donor's checkpoint with a
            # mutated config. Counts as the same trial (same id).
            new_config, donor_ckpt = scheduler.exploit(t.trial_id)
            ray_tpu_torch.kill(t.actor)
            t.config = new_config
            t.restore_from = donor_ckpt
            t.perturbations += 1
            self._start_trial(t, fn, exp_dir, tc, scheduler)
            return True, True
        if decision == STOP and not p["done"]:
            t.state = "STOPPED"
            ray_tpu_torch.kill(t.actor)
            scheduler.on_trial_complete(t.trial_id)
            if searcher:
                searcher.on_trial_complete(t.trial_id, t.metrics)
            self._cb("on_trial_complete", t)
            return False, True
        if p["done"]:
            if p["error"]:
                ray_tpu_torch.kill(t.actor)
                if self._maybe_retry_trial(t, p["error"], fn,
                                           exp_dir, tc, scheduler):
                    return True, True
            t.state = "ERROR" if p["error"] else "COMPLETED"
            t.error = p["error"]
            scheduler.on_trial_complete(t.trial_id)
            if searcher:
                searcher.on_trial_complete(t.trial_id, t.metrics,
                                           error=bool(p["error"]))
            if not p["error"]:
                ray_tpu_torch.kill(t.actor)
            self._cb("on_trial_error" if p["error"]
                     else "on_trial_complete", t)
            return False, True
        return True, changed

    def _maybe_retry_trial(self, t: Trial, error: str, fn,
                           exp_dir: str, tc: TuneConfig,
                           scheduler) -> bool:
        """FailureConfig.max_failures (reference: failed trials
        restart from their latest checkpoint up to max_failures;
        -1 = unlimited)."""
        max_failures = self.run_config.failure_config.max_failures
        if max_failures != -1 and t.failures >= max_failures:
            return False
        t.failures += 1
        import warnings
        warnings.warn(
            f"trial {t.trial_id} failed "
            f"({t.failures}/{max_failures}): {error!r}; restarting "
            f"from {t.checkpoint_dir or 'scratch'}")
        try:
            ray_tpu_torch.kill(t.actor)
        except Exception:  # noqa: BLE001 — already dead
            pass
        t.restore_from = t.checkpoint_dir
        self._start_trial(t, fn, exp_dir, tc, scheduler)
        return True


def _as_function_trainable(trainable) -> Callable:
    from ray_tpu_torch.train.trainer import TorchTrainer

    from ray_tpu_torch.tune.classic import Trainable, _class_trainable_fn
    if isinstance(trainable, type) and issubclass(trainable,
                                                  Trainable):
        return _class_trainable_fn(trainable)
    if isinstance(trainable, TorchTrainer):
        def run_trainer(config):
            from ray_tpu_torch.train import report
            trainer = TorchTrainer(
                trainable.train_loop,
                train_loop_config={**trainable.loop_config, **config},
                scaling_config=trainable.scaling,
                run_config=trainable.run_config,
            )
            result = trainer.fit()
            if result.error:
                raise RuntimeError(result.error)
            report(result.metrics)
        return run_trainer
    if callable(trainable):
        return trainable
    raise TypeError(f"unsupported trainable: {type(trainable)}")
