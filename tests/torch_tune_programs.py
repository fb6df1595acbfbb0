"""Small Tune programs, each run once on ``ray_tpu`` and once on
``ray_tpu_torch`` (tests/test_torch_tune_parity.py and
tests/test_torch_tune_classic.py).

Every program takes the package module (``rt``), reaches Tune and Train
as ``rt.tune`` and ``rt.train`` and the runtime through ``rt.remote`` and
``rt.get``, so the same code runs on both. It returns a plain result that
holds only what a run decides (configs, states, metrics, decision sets,
error texts), never a time or a path. Where the run depends on the order
in which trials' results arrive (ASHA's rungs, PBT's and PB2's
exploits), the result is an invariant of every order: each population
starts its trials together behind a barrier, so that its members
overlap, PBT's and PB2's trials wait after each report until the
controller has handled it (a callback marks it), so that none finishes
before the scheduler has decided on its results, and the program checks
what every exploit must satisfy, not which exploit happened. The programs cover the behaviours of the JAX
package's ``tests/test_tune*.py``; :data:`EXPECTED` holds what each must
give.

A trainable runs in a runtime worker of either package and finds its
package's ``train`` through the session that runs it (:func:`_train`).
Nothing here imports either package at module level.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def _sub(rt, name: str):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _train():
    """The ``train`` package whose session runs this trainable."""
    for pkg in ("ray_tpu_torch", "ray_tpu"):
        session = sys.modules.get(f"{pkg}.train.session")
        if session is not None and session._session is not None:
            return importlib.import_module(f"{pkg}.train")
    raise RuntimeError("no train session runs here")


@contextlib.contextmanager
def _storage():
    d = tempfile.mkdtemp(prefix="tune_prog_")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def barrier(directory: str, n: int, timeout: float = 120.0) -> None:
    """Wait until ``n`` trials have reached this point (a file each in
    ``directory``), so that a population's trials overlap in time."""
    with open(os.path.join(directory, f"{os.getpid()}-{time.time_ns()}"),
              "w"):
        pass
    deadline = time.monotonic() + timeout
    while len(os.listdir(directory)) < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{len(os.listdir(directory))} of {n} "
                               "trials reached the barrier")
        time.sleep(0.01)


def _states(grid) -> list[str]:
    return sorted(r.state for r in grid)


# -- Tuner: search, schedulers, errors, restore -------------------------------


def quadratic(config):
    report = _train().report
    for i in range(5):
        report({"loss": (config["x"] - 3.0) ** 2 + 1.0 / (i + 1)})


def grid_search(rt):
    tune, train = _sub(rt, "tune"), _sub(rt, "train")
    with _storage() as d:
        grid = tune.Tuner(
            quadratic, param_space={"x": tune.grid_search([0.0, 3.0, 6.0])},
            run_config=train.RunConfig(storage_path=d)).fit()
    best = grid.get_best_result("loss", mode="min")
    return [len(grid), len(grid.errors), best.config, best.metrics["loss"],
            _states(grid),
            sorted(len(r.metrics_history) for r in grid)]


def echo_config(config):
    _train().report({"loss": config["x"]})


def random_search(rt):
    """The sampled configs of a seeded search, and the best of them."""
    tune, train = _sub(rt, "tune"), _sub(rt, "train")
    space = {"lr": tune.loguniform(1e-5, 1e-1), "wd": tune.choice([0, 1]),
             "x": tune.uniform(0, 1), "n": tune.randint(1, 9),
             "g": tune.grid_search(["a", "b"])}
    with _storage() as d:
        grid = tune.Tuner(
            echo_config, param_space=space,
            tune_config=tune.TuneConfig(num_samples=2, seed=0),
            run_config=train.RunConfig(storage_path=d)).fit()
    configs = sorted((sorted(r.config.items()) for r in grid), key=str)
    best = grid.get_best_result("loss", "min").config
    return [configs, best["x"] == min(r.config["x"] for r in grid),
            _states(grid)]


def asha_pruning(rt):
    """Bad trials step slower, so every rung has seen a good trial before
    a bad one reaches it: ASHA stops bad trials early, never a good
    one."""
    tune, train = _sub(rt, "tune"), _sub(rt, "train")
    with _storage() as d, _storage() as gate:
        def iterative(config):
            report = _train().report
            barrier(gate, 4)
            bad = config["quality"] > 10
            for i in range(8):
                time.sleep(0.15 if bad else 0.03)
                report({"loss": config["quality"] / (i + 1)})

        grid = tune.Tuner(
            iterative,
            param_space={"quality": tune.grid_search([1.0, 1.0, 100.0,
                                                      100.0])},
            tune_config=tune.TuneConfig(
                scheduler=tune.ASHAScheduler(metric="loss", mode="min",
                                             max_t=8, grace_period=2,
                                             reduction_factor=2),
                max_concurrent_trials=4),
            run_config=train.RunConfig(storage_path=d)).fit()
    early = sorted(r.config["quality"] for r in grid
                   if len(r.metrics_history) < 8)
    return [grid.get_best_result("loss", "min").config["quality"],
            early, len(grid.errors)]


def error_isolation(rt):
    tune, train = _sub(rt, "tune"), _sub(rt, "train")

    def sometimes_bad(config):
        if config["x"] == 1:
            raise RuntimeError("bad trial")
        _train().report({"loss": config["x"]})

    with _storage() as d:
        grid = tune.Tuner(
            sometimes_bad, param_space={"x": tune.grid_search([0, 1, 2])},
            run_config=train.RunConfig(storage_path=d)).fit()
    return [len(grid.errors), "bad trial" in grid.errors[0].error,
            grid.get_best_result("loss").config["x"], _states(grid)]


def hyperband(rt):
    """HyperBand's first bracket never stops: the x = 0 trial (the first
    added) runs to max_t and is best."""
    tune, train = _sub(rt, "tune"), _sub(rt, "train")

    def trainable(config):
        report = _train().report
        for i in range(1, 10):
            time.sleep(0.01)
            report({"loss": config["x"] + 1.0 / i, "training_iteration": i})

    hb = tune.HyperBandScheduler(metric="loss", mode="min", max_t=9,
                                 reduction_factor=3)
    with _storage() as d:
        grid = tune.Tuner(
            trainable,
            param_space={"x": tune.grid_search([0.0, 5.0, 10.0, 0.5])},
            tune_config=tune.TuneConfig(scheduler=hb,
                                        max_concurrent_trials=4),
            run_config=train.RunConfig(storage_path=d)).fit()
    best = grid.get_best_result("loss", mode="min")
    return [len(hb._brackets), best.config["x"], best.metrics["loss"],
            len(grid.errors)]


def bohb_hyperband(rt):
    """BOHB suggesting, HyperBand stopping: the suggestions depend on
    which rung results arrived first, so only their bounds are read."""
    tune, train = _sub(rt, "tune"), _sub(rt, "train")

    def trainable(config):
        report = _train().report
        for step in range(1, 9):
            report({"loss": (config["x"] - 2.0) ** 2 + 1.0 / step,
                    "training_iteration": step})

    with _storage() as d:
        grid = tune.Tuner(
            trainable, param_space={"x": tune.uniform(-5, 5)},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", num_samples=6,
                search_alg=tune.BOHBSearcher(
                    {"x": tune.uniform(-5, 5)}, metric="loss", mode="min",
                    num_samples=6, n_startup=4, seed=1),
                scheduler=tune.HyperBandScheduler(metric="loss", mode="min",
                                                  max_t=8)),
            run_config=train.RunConfig(storage_path=d)).fit()
    best = grid.get_best_result(metric="loss", mode="min")
    return [len(grid), all(-5 <= r.config["x"] <= 5 for r in grid),
            best.metrics["loss"] < 20, len(grid.errors)]


def wait_for_ack(acks: str, trial_id: str, iteration: int,
                 timeout: float = 120.0) -> None:
    """Wait until the controller has seen this trial's result
    ``iteration`` (:func:`ack_callback` wrote its file)."""
    path = os.path.join(acks, f"{trial_id}-{iteration}")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no ack of {trial_id} result {iteration}")
        time.sleep(0.005)


def ack_callback(tune, acks: str):
    """A ``tune.Callback`` that marks each result the controller handles
    (``on_trial_result`` runs just before the scheduler decides on it)."""

    class Ack(tune.Callback):
        def on_trial_result(self, iteration, trials, trial, result):
            with open(os.path.join(
                    acks, f"{trial.trial_id}-{result['training_iteration']}"),
                    "w"):
                pass

    return Ack()


def population_trainable(gate: str, acks: str, n: int, steps: int, rate):
    """A trainable whose state is (step, score): each step reports the
    score it holds, then adds ``rate(config)`` and checkpoints, and waits
    until the controller has handled the report (so that no trial runs
    ahead of the scheduler's decisions, however slow the controller). A
    restarted trial reports first the score of the checkpoint it
    restored (and the checkpoint's path, as ``restored``), as a train
    step reports the loss of the weights it starts from."""

    def trainable(config):
        train = _train()
        ctx = train.get_context()
        trial_id = os.path.basename(os.path.normpath(ctx.trial_dir))
        step, score = 0, 0.0
        if ctx.restored_checkpoint_dir:
            with open(os.path.join(ctx.restored_checkpoint_dir,
                                   "state.json")) as f:
                s = json.load(f)
            step, score = s["step"], s["score"]
        else:
            barrier(gate, n)
        while step < steps:
            time.sleep(0.01)
            metrics = {"score": score, "restored":
                       ctx.restored_checkpoint_dir or ""}
            step += 1
            score += rate(config)
            metrics["training_iteration"] = step
            with tempfile.TemporaryDirectory() as tmp:
                with open(os.path.join(tmp, "state.json"), "w") as f:
                    json.dump({"step": step, "score": score}, f)
                train.report(metrics,
                             checkpoint=train.Checkpoint.from_directory(tmp))
            wait_for_ack(acks, trial_id, step)

    return trainable


def exploit_recorder(cls):
    """``cls`` (PBT or PB2) recording, at every exploit, the trial, the
    donor's checkpoint and whether the donor was in the upper quantile."""

    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.log = []

        def exploit(self, trial_id):
            _, upper = self._quantiles()
            config, ckpt = super().exploit(trial_id)
            self.log.append((trial_id, ckpt, config, any(
                self._ckpt.get(u) == ckpt for u in upper)))
            return config, ckpt

    return Recorded


def exploit_invariants(sched, grid) -> list:
    """[an exploit happened, every donor was in the upper quantile, how
    many restarts were read (at least one), each restarted trial's first
    score equal to its donor checkpoint's]."""
    by_id = {r.trial_id: r for r in grid}
    checked, equal = 0, []
    for trial_id, ckpt, _, _ in sched.log:
        after = [m for m in by_id[trial_id].metrics_history
                 if m.get("restored") == ckpt]
        if not after:
            continue          # restored at the last step: nothing after
        with open(os.path.join(ckpt, "state.json")) as f:
            donor = json.load(f)["score"]
        checked += 1
        equal.append(after[0]["score"] == donor)
    return [sched.exploit_count >= 1, all(up for *_, up in sched.log),
            checked >= 1, all(equal)]


def pbt(rt):
    """Four trials whose scores grow at their lr; the slowest is alone at
    the bottom (two tied at the bottom, each would see the other as the
    lower quantile at its own boundary, and neither be exploited)."""
    tune, train = _sub(rt, "tune"), _sub(rt, "train")
    sched = exploit_recorder(tune.PopulationBasedTraining)(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": [0.1, 0.5, 1.0]},
        quantile_fraction=0.25, seed=0)
    with _storage() as d, _storage() as gate, _storage() as acks:
        grid = tune.Tuner(
            population_trainable(gate, acks, 4, 16, lambda c: c["lr"]),
            param_space={"lr": tune.grid_search([0.1, 0.5, 1.0, 1.0])},
            tune_config=tune.TuneConfig(scheduler=sched, metric="score",
                                        mode="max",
                                        max_concurrent_trials=4),
            run_config=train.RunConfig(
                storage_path=d, name="pbt",
                callbacks=[ack_callback(tune, acks)])).fit()
        out = exploit_invariants(sched, grid)
    mutated = all(cfg["lr"] in (0.1, 0.5, 1.0, 0.08, 0.12, 0.4, 0.6, 0.8,
                                1.2) for *_, cfg, _ in sched.log)
    return out + [mutated, len(grid.errors)]


def pb2(rt):
    tune, train = _sub(rt, "tune"), _sub(rt, "train")
    sched = exploit_recorder(tune.PB2)(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_bounds={"lr": [0.0, 1.0]}, seed=0)
    with _storage() as d, _storage() as gate, _storage() as acks:
        grid = tune.Tuner(
            population_trainable(gate, acks, 4, 16,
                                 lambda c: 1.0 - (c["lr"] - 0.8) ** 2),
            param_space={"lr": tune.grid_search([0.0, 0.4, 0.8, 0.8])},
            tune_config=tune.TuneConfig(scheduler=sched, metric="score",
                                        mode="max",
                                        max_concurrent_trials=4),
            run_config=train.RunConfig(
                storage_path=d, name="pb2",
                callbacks=[ack_callback(tune, acks)])).fit()
        out = exploit_invariants(sched, grid)
    bounded = all(0.0 <= cfg["lr"] <= 1.0 for *_, cfg, _ in sched.log)
    return out + [bounded, len(grid.errors)]


def restore(rt):
    """A failed trial re-runs clean from the experiment's journal."""
    tune, train = _sub(rt, "tune"), _sub(rt, "train")
    with _storage() as d:
        marker = os.path.join(d, "marker")

        def flaky(config):
            if config["x"] == 1 and not os.path.exists(marker):
                with open(marker, "w"):
                    pass
                raise RuntimeError("injected first-run failure")
            _train().report({"loss": float(config["x"])})

        grid = tune.Tuner(
            flaky, param_space={"x": tune.grid_search([0, 1, 2])},
            run_config=train.RunConfig(storage_path=d, name="exp")).fit()
        exp_dir = os.path.join(d, "exp")
        journal = os.path.exists(os.path.join(exp_dir,
                                              "experiment_state.json"))
        grid2 = tune.Tuner.restore(exp_dir, flaky).fit()
    return [len(grid.errors), journal, len(grid2), len(grid2.errors),
            sorted(r.metrics["loss"] for r in grid2)]


def tuner_over_trainer(rt):
    """A trainer as the trainable: each trial fits a one-worker gang (on
    the CPU) with the trial's config merged into its loop's."""
    tune, train = _sub(rt, "tune"), _sub(rt, "train")

    def loop(config):
        _train().report({"loss": abs(config["lr"] - 0.01),
                         "lr": config["lr"]})

    with _storage() as d:
        if rt.__name__ == "ray_tpu":
            trainer = train.JaxTrainer(
                loop, scaling_config=train.ScalingConfig(num_workers=1),
                run_config=train.RunConfig(storage_path=d))
        else:
            trainer = train.TorchTrainer(
                loop, scaling_config=train.ScalingConfig(
                    num_workers=1, gpus_per_worker=0),
                run_config=train.RunConfig(storage_path=d))
        grid = tune.Tuner(
            trainer, param_space={"lr": tune.grid_search([0.1, 0.01])},
            run_config=train.RunConfig(storage_path=d)).fit()
    best = grid.get_best_result("loss")
    return [len(grid.errors), best.config, best.metrics["lr"]]


class MockTrial:
    """A duck-typed ``optuna.Trial`` answering from a table."""

    def __init__(self, number, answers=None):
        self.number = number
        self.params = {}
        self._answers = answers or {}

    def suggest_float(self, name, low, high, log=False):
        v = self._answers.get(name, (low + high) / 2.0)
        self.params[name] = v
        return v

    def suggest_int(self, name, low, high):
        v = int(self._answers.get(name, low))
        self.params[name] = v
        return v

    def suggest_categorical(self, name, values):
        v = self._answers.get(name, values[0])
        self.params[name] = v
        return v


class MockStudy:
    """A duck-typed ``optuna.Study`` recording every ask and tell."""

    def __init__(self, answers_per_trial=None):
        self.asked = 0
        self.tells = []
        self._answers = answers_per_trial or []

    def ask(self):
        ans = (self._answers[self.asked]
               if self.asked < len(self._answers) else {})
        t = MockTrial(self.asked, ans)
        self.asked += 1
        return t

    def tell(self, trial, value=None, state=None):
        self.tells.append((trial.number, value, state))


def optuna_study(rt):
    """OptunaSearch over a duck-typed study drives a Tuner; without a
    study and without optuna it raises ImportError."""
    tune, train = _sub(rt, "tune"), _sub(rt, "train")
    try:
        tune.OptunaSearch({"x": tune.uniform(0, 1)})
        missing = None
    except ImportError as e:
        missing = "optuna" in str(e)
    study = MockStudy([{"x": float(i)} for i in range(4)])
    search = tune.OptunaSearch({"x": tune.uniform(0.0, 10.0)},
                               metric="score", mode="min", num_samples=4,
                               study=study)

    def trainable(config):
        _train().report({"score": (config["x"] - 2.0) ** 2})

    with _storage() as d:
        grid = tune.Tuner(
            trainable, tune_config=tune.TuneConfig(
                search_alg=tune.ConcurrencyLimiter(search, max_concurrent=2),
                metric="score", mode="min"),
            run_config=train.RunConfig(storage_path=d)).fit()
    best = grid.get_best_result("score", "min")
    return [missing, len(grid), study.asked,
            sorted(n for n, _, _ in study.tells), best.config,
            best.metrics["score"]]


def time_budget(rt):
    """time_budget_s stops admission and halts running trials."""
    tune, train = _sub(rt, "tune"), _sub(rt, "train")

    def slow(config):
        report = _train().report
        for i in range(1000):
            time.sleep(0.1)
            report({"i": i})

    t0 = time.monotonic()
    with _storage() as d:
        grid = tune.Tuner(
            slow, tune_config=tune.TuneConfig(num_samples=50,
                                              time_budget_s=2.0),
            run_config=train.RunConfig(storage_path=d, name="budget")).fit()
    return [time.monotonic() - t0 < 30, len(grid) < 50,
            all(r.state in ("STOPPED", "COMPLETED", "ERROR") for r in grid)]


# -- the classic surface -----------------------------------------------------


def quad_class(tune):
    class Quad(tune.Trainable):
        """Minimises (x - 3)^2 by gradient steps; checkpoints x."""

        def setup(self, config):
            self.x = config.get("x0", 0.0)
            self.lr = config["lr"]

        def step(self):
            self.x -= self.lr * 2 * (self.x - 3.0)
            return {"loss": (self.x - 3.0) ** 2,
                    "done": self.iteration >= 19}

        def save_checkpoint(self, checkpoint_dir):
            with open(os.path.join(checkpoint_dir, "x.txt"), "w") as f:
                f.write(repr(self.x))
            return checkpoint_dir

        def load_checkpoint(self, checkpoint_dir):
            with open(os.path.join(checkpoint_dir, "x.txt")) as f:
                self.x = float(f.read())

    return Quad


def class_trainable(rt):
    tune = _sub(rt, "tune")
    with _storage() as d:
        grid = tune.run(quad_class(tune),
                        config={"lr": tune.grid_search([0.1, 0.4])},
                        storage_path=d, name="quad")
        best = grid.get_best_result("loss", "min")
        ckpt = bool(best.checkpoint_dir) and os.path.isdir(
            best.checkpoint_dir)
    return [len(grid), best.config, best.metrics["loss"],
            best.metrics["training_iteration"], ckpt]


def class_resume(rt):
    """A class trainable that crashed at iteration 5 resumes from its
    checkpoint and still ends at iteration 20."""
    tune = _sub(rt, "tune")
    Quad = quad_class(tune)

    class FailOnce(Quad):
        def step(self):
            marker = self.config["marker"]
            if self.iteration == 5 and not os.path.exists(marker):
                with open(marker, "w") as f:
                    f.write("x")
                raise RuntimeError("mid-flight crash")
            return super().step()

    with _storage() as d:
        grid = tune.run(FailOnce, config={"lr": 0.4,
                                          "marker": os.path.join(d, "m")},
                        storage_path=d, name="resume_me")
        r = tune.Tuner.restore(os.path.join(d, "resume_me"),
                               FailOnce).fit()[0]
    return [grid[0].state, r.state, r.metrics["training_iteration"],
            r.metrics["loss"]]


def class_dict_checkpoint(rt):
    """save_checkpoint returning a dict round-trips into load_checkpoint
    on resume."""
    tune = _sub(rt, "tune")

    class DictCkpt(tune.Trainable):
        def setup(self, config):
            self.x = 0.0
            self.marker = config["marker"]

        def step(self):
            if self.iteration == 3 and not os.path.exists(self.marker):
                with open(self.marker, "w") as f:
                    f.write("x")
                raise RuntimeError("crash after 3")
            self.x += 1.0
            return {"x": self.x, "done": self.iteration >= 7}

        def save_checkpoint(self, checkpoint_dir):
            return {"x": self.x}

        def load_checkpoint(self, checkpoint):
            assert isinstance(checkpoint, dict), checkpoint
            self.x = checkpoint["x"]

    with _storage() as d:
        tune.run(DictCkpt, config={"marker": os.path.join(d, "m")},
                 storage_path=d, name="dictc")
        r = tune.Tuner.restore(os.path.join(d, "dictc"), DictCkpt).fit()[0]
    return [r.state, r.metrics["x"], r.metrics["training_iteration"]]


def callbacks_reporter(rt):
    tune = _sub(rt, "tune")
    events = []

    class Rec(tune.Callback):
        def on_trial_start(self, it, trials, trial):
            events.append(("start",))

        def on_trial_result(self, it, trials, trial, result):
            events.append(("result", result["training_iteration"]))

        def on_trial_complete(self, it, trials, trial):
            events.append(("complete",))

        def on_experiment_end(self, trials, **info):
            events.append(("end", len(trials)))

    reporter = tune.CLIReporter(metric_columns=["loss"],
                                max_report_frequency=0.0)
    out = io.StringIO()
    with _storage() as d, contextlib.redirect_stdout(out):
        grid = tune.run(quad_class(tune), config={"lr": 0.4},
                        callbacks=[Rec()], progress_reporter=reporter,
                        storage_path=d, name="cbs")
    text = out.getvalue()
    return [len(grid), events[0], [e[1] for e in events
                                   if e[0] == "result"],
            ("complete",) in events, events[-1],
            "== Status ==" in text and "loss" in text]


def experiment_analysis(rt):
    tune = _sub(rt, "tune")
    with _storage() as d:
        tune.run(quad_class(tune),
                 config={"lr": tune.grid_search([0.05, 0.4])},
                 storage_path=d, name="ana")
        ana = tune.ExperimentAnalysis(os.path.join(d, "ana"))
        ckpt = ana.get_best_checkpoint("loss", "min")
        out = [len(ana.trials), ana.get_best_trial("loss", "min")["config"],
               ana.get_best_config("loss", "min"),
               bool(ckpt) and os.path.isdir(ckpt)]
        df = ana.dataframe()
        out += [len(df), "config/lr" in df.columns]
        try:
            ana.get_best_trial()
        except ValueError as e:
            out.append(str(e))
    return out


def placement_group_factory(rt):
    """Bundles merge into one trial demand; the accelerator key is each
    package's (TPU for the JAX package, GPU for the port), read back as
    ACC."""
    tune = _sub(rt, "tune")
    acc = "TPU" if rt.__name__ == "ray_tpu" else "GPU"
    pgf = tune.PlacementGroupFactory([{"CPU": 1}, {"CPU": 1, acc: 0}])
    try:
        tune.PlacementGroupFactory([])
        empty = None
    except ValueError as e:
        empty = str(e)

    def trainable(config):
        _train().report({"loss": 0.0})

    wrapped = tune.with_resources(trainable, pgf)
    with _storage() as d:
        grid = tune.run(wrapped, storage_path=d, name="pgf")

    def named(res):
        return sorted(("ACC" if k == acc else k, v) for k, v in res.items())

    return [named(pgf.required_resources), empty,
            named(wrapped._tune_resources), grid[0].state]


def run_experiments(rt):
    tune = _sub(rt, "tune")

    def t1(config):
        _train().report({"score": config["a"]})

    with _storage() as d:
        out = tune.run_experiments({
            "exp_a": {"run": t1, "config": {"a": 1}, "storage_path": d},
            "exp_b": {"run": t1, "config": {"a": 2}, "storage_path": d},
        })
    try:
        tune.run_experiments({"x": {"run": t1, "bogus": 1}})
        err = None
    except tune.TuneError as e:
        err = "unsupported spec" in str(e)
    return [sorted(out), out["exp_b"][0].metrics["score"], err]


class TinyEnv:
    """A two-state toy environment (no gymnasium)."""

    def __init__(self):
        class Space:
            def __init__(self, n):
                self.n = n
                self.shape = (2,)
        self.observation_space = Space(2)
        self.action_space = Space(2)
        self._t = 0

    def reset(self, *, seed=None, options=None):
        self._t = 0
        return np.zeros(2, dtype=np.float32), {}

    def step(self, action):
        self._t += 1
        return (np.zeros(2, dtype=np.float32), float(action == 1),
                self._t >= 8, False, {})


def register_env(rt):
    """A name registered in the driver resolves in a task and in an actor
    (where an env runner would build it) through the cluster KV."""
    tune = _sub(rt, "tune")
    tune.register_env("tiny-reg-env", TinyEnv)
    pkg = rt.__name__

    def build(name):
        registry = importlib.import_module(f"{pkg}.tune.registry")
        creator = registry.get_registered_env(name)
        if creator is None:
            return None
        env = creator()
        env.reset()
        return [env.action_space.n, list(env.observation_space.shape),
                env.step(1)[1]]

    class Runner:
        def make(self, name):
            return build(name)

    runner = rt.remote(Runner).remote()
    try:
        return [rt.get(rt.remote(build).remote("tiny-reg-env"), timeout=60),
                rt.get(runner.make.remote("tiny-reg-env"), timeout=60),
                rt.get(runner.make.remote("never-registered"), timeout=60)]
    finally:
        rt.kill(runner)


def resume_config(rt):
    tune = _sub(rt, "tune")

    def die(config):
        raise RuntimeError("always fails")

    with _storage() as d:
        tune.run(die, storage_path=d, name="dead")
        grid = tune.Tuner.restore(
            os.path.join(d, "dead"), die,
            resume_config=tune.ResumeConfig(resume_errored=False)).fit()
    return grid[0].state


def failure_retries(rt):
    """FailureConfig.max_failures: the trial dies once at i = 2 and
    retries from its latest checkpoint."""
    tune, train = _sub(rt, "tune"), _sub(rt, "train")
    with _storage() as d:
        marker = os.path.join(d, "attempts")

        def flaky(config):
            t = _train()
            with open(marker, "a") as f:
                f.write("x")
            with open(marker) as f:
                attempts = len(f.read())
            ckpt = t.get_checkpoint()
            start = 0
            if ckpt is not None:
                with open(os.path.join(ckpt.path, "i.txt")) as f:
                    start = int(f.read())
            for i in range(start, 6):
                with tempfile.TemporaryDirectory() as tmp:
                    with open(os.path.join(tmp, "i.txt"), "w") as f:
                        f.write(str(i + 1))
                    t.report({"i": i}, checkpoint=t.Checkpoint(tmp))
                if i == 2 and attempts == 1:
                    raise RuntimeError("first attempt dies at i=2")
            t.report({"final": True})

        grid = tune.Tuner(
            flaky, run_config=train.RunConfig(
                storage_path=d, name="retry",
                failure_config=train.FailureConfig(max_failures=2))).fit()
        with open(marker) as f:
            attempts = len(f.read())
    r = grid[0]
    return [r.state, attempts, [m.get("i") for m in r.metrics_history]]


def failure_exhausted(rt):
    tune, train = _sub(rt, "tune"), _sub(rt, "train")

    def die(config):
        raise RuntimeError("always")

    with _storage() as d:
        grid = tune.Tuner(
            die, run_config=train.RunConfig(
                storage_path=d, name="die",
                failure_config=train.FailureConfig(max_failures=1))).fit()
    return [grid[0].state, "always" in grid[0].error]


def run_resume(rt):
    """tune.run(resume=True) continues the named experiment."""
    tune = _sub(rt, "tune")
    out = []
    with _storage() as d:
        marker = os.path.join(d, "attempted")

        def flaky(config):
            if not os.path.exists(marker):
                with open(marker, "w") as f:
                    f.write("x")
                raise RuntimeError("first run dies")
            _train().report({"ok": 1})

        out.append(tune.run(flaky, storage_path=d, name="res")[0].state)
        out.append(tune.run(flaky, storage_path=d, name="res",
                            resume=True)[0].state)
        for kwargs in ({}, {"storage_path": d, "name": "ghost"}):
            try:
                tune.run(flaky, resume=True, **kwargs)
            except ValueError as e:
                out.append(str(e).replace(d, "<storage>"))
    return out


def with_parameters_dict_stop(rt):
    """with_parameters binds a large object once; a dict stop ends each
    trial at its fifth report (score >= 4)."""
    tune = _sub(rt, "tune")
    big = list(range(20_000))

    def obj(config, table):
        report = _train().report
        assert len(table) == 20_000
        for i in range(10):
            report({"loss": config["x"], "score": i})

    with _storage() as d:
        grid = tune.run(tune.with_parameters(obj, table=big),
                        config={"x": tune.grid_search([0.1, 0.2])},
                        metric="loss", mode="min", stop={"score": 4},
                        storage_path=d)
    return [len(grid), sorted(len(r.metrics_history) for r in grid),
            _states(grid)]


def register_trainable_stoppers(rt):
    tune = _sub(rt, "tune")

    def ten(config):
        report = _train().report
        for _ in range(10):
            report({"loss": 1.0})

    tune.register_trainable("compat_obj", ten)
    out = []
    with _storage() as d:
        grid = tune.run("compat_obj", config={},
                        stop=tune.MaximumIterationStopper(3),
                        storage_path=d)
        out.append([len(r.metrics_history) for r in grid])
        for name, kwargs in (("never_registered", {}),
                             ("compat_obj", {"fancy_new_arg": 1})):
            try:
                tune.run(name, config={}, storage_path=d, **kwargs)
            except (ValueError, TypeError) as e:
                out.append([type(e).__name__,
                            "register_trainable" in str(e)
                            or "unsupported arguments" in str(e)])
    return out


# -- tables ---------------------------------------------------------------

API = {
    "grid_search": grid_search,
    "random_search": random_search,
    "asha_pruning": asha_pruning,
    "error_isolation": error_isolation,
    "hyperband": hyperband,
    "bohb_hyperband": bohb_hyperband,
    "pbt": pbt,
    "pb2": pb2,
    "restore": restore,
    "tuner_over_trainer": tuner_over_trainer,
    "optuna_study": optuna_study,
    "time_budget": time_budget,
}

CLASSIC = {
    "class_trainable": class_trainable,
    "class_resume": class_resume,
    "class_dict_checkpoint": class_dict_checkpoint,
    "callbacks_reporter": callbacks_reporter,
    "experiment_analysis": experiment_analysis,
    "placement_group_factory": placement_group_factory,
    "run_experiments": run_experiments,
    "register_env": register_env,
    "resume_config": resume_config,
    "failure_retries": failure_retries,
    "failure_exhausted": failure_exhausted,
    "run_resume": run_resume,
    "with_parameters_dict_stop": with_parameters_dict_stop,
    "register_trainable_stoppers": register_trainable_stoppers,
}


def run(fn, rt):
    """("ok", result) or ("raised", type, message) of one program."""
    try:
        return ("ok", fn(rt))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("raised", type(e).__name__, str(e)[:500])


def run_table(name: str, table: dict) -> dict:
    """{program: outcome} of every program of ``table`` on package
    ``name``, in one runtime of ``num_cpus=4``."""
    import warnings
    rt = importlib.import_module(name)
    rt.init(num_cpus=4)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return {prog: run(fn, rt) for prog, fn in table.items()}
    finally:
        rt.shutdown()


_DONE4 = ["COMPLETED"] * 4
# An exploit happened, every donor was in the upper quantile, a restart
# was read, each restart's first score was its donor's, the mutations
# (PBT) or bounds (PB2) held, no trial errored.
_EXPLOITS = [True, True, True, True, True, 0]
# What each program must give (the same on both packages, and right).
EXPECTED = {
    "grid_search": [3, 0, {"x": 3.0}, 0.2, ["COMPLETED"] * 3, [5, 5, 5]],
    "random_search": [
        [[("g", "a"), ("lr", 0.002155401386159288), ("n", 5), ("wd", 0),
          ("x", 0.5046868558173903)],
         [("g", "a"), ("lr", 0.02386093216690149), ("n", 8), ("wd", 1),
          ("x", 0.04048437818077755)],
         [("g", "b"), ("lr", 0.00041661658030924307), ("n", 6), ("wd", 1),
          ("x", 0.9677999949201714)],
         [("g", "b"), ("lr", 3.622289357312649e-05), ("n", 5), ("wd", 0),
          ("x", 0.6183689966753316)]], True, _DONE4],
    "asha_pruning": [1.0, [100.0, 100.0], 0],
    "error_isolation": [1, True, 0, ["COMPLETED", "COMPLETED", "ERROR"]],
    "hyperband": [3, 0.0, 0.0 + 1.0 / 9, 0],
    "bohb_hyperband": [6, True, True, 0],
    "pbt": _EXPLOITS,
    "pb2": _EXPLOITS,
    "restore": [1, True, 3, 0, [0.0, 1.0, 2.0]],
    "tuner_over_trainer": [0, {"lr": 0.01}, 0.01],
    "optuna_study": [True, 4, 4, [0, 1, 2, 3], {"x": 2.0}, 0.0],
    "time_budget": [True, True, True],
    "class_trainable": [2, {"lr": 0.4}, 9.941619558047801e-28, 20, True],
    "class_resume": ["ERROR", "COMPLETED", 20, 9.941619558047801e-28],
    "class_dict_checkpoint": ["COMPLETED", 8.0, 8],
    "callbacks_reporter": [1, ("start",), list(range(1, 21)), True,
                           ("end", 1), True],
    "experiment_analysis": [2, {"lr": 0.4}, {"lr": 0.4}, True, 2, True,
                            "pass metric= (or default_metric)"],
    "placement_group_factory": [[("ACC", 0.0), ("CPU", 2.0)],
                                "need at least one bundle",
                                [("ACC", 0.0), ("CPU", 2.0)], "COMPLETED"],
    "run_experiments": [["exp_a", "exp_b"], 2, True],
    "register_env": [[2, [2], 1.0], [2, [2], 1.0], None],
    "resume_config": "ERROR",
    "failure_retries": ["COMPLETED", 2, [0, 1, 2, 3, 4, 5, None]],
    "failure_exhausted": ["ERROR", True],
    "run_resume": [
        "ERROR", "COMPLETED",
        "tune.run(resume=True) needs name= and storage_path= to locate the "
        "experiment journal",
        "resume=True but no journal at '<storage>/ghost'"],
    "with_parameters_dict_stop": [2, [5, 5], ["COMPLETED", "COMPLETED"]],
    "register_trainable_stoppers": [[3], ["ValueError", True],
                                    ["TypeError", True]],
}
