"""Every searcher and scheduler of the port's Tune against the JAX
package's, with no runtime: each case feeds both packages' objects the
same result sequence from the same seed and reads back what they decide
(suggested configs, CONTINUE/STOP/EXPLOIT, exploited configs and
checkpoints, stopper answers). Suggestions and decisions must be equal
exactly; PB2's Gaussian process (means and deviations) within 1e-12. A
second check holds each case's outcome to what the JAX package's own
unit tests require of it (``tests/test_tune*.py``), so that both packages
wrong in the same way fail too.
"""

from __future__ import annotations

import importlib
import random

import numpy as np
import pytest

import torch_tune_programs as programs

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _tune(pkg: str):
    return importlib.import_module(f"{pkg}.tune")


def _sub(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.tune.{name}")


def basic_variant(pkg):
    tune = _tune(pkg)
    gen = tune.BasicVariantGenerator(
        {"lr": tune.grid_search([0.1, 0.01]), "wd": tune.choice([0, 1]),
         "x": tune.uniform(0, 1)}, num_samples=3, seed=0)
    cfgs = [gen.suggest(f"t{i}") for i in range(6)]
    return [gen.total(), cfgs, gen.suggest("t7")]


def samplers(pkg):
    tune = _tune(pkg)
    sample = _sub(pkg, "search")._sample
    r = random.Random(0)
    specs = [tune.quniform(0, 1, 0.25), tune.qrandint(0, 100, 10),
             tune.lograndint(1, 1000), tune.randn(0, 1),
             tune.qloguniform(1e-4, 1e-1, 1e-4), tune.qrandn(0, 1, 0.5),
             tune.qlograndint(1, 1000, 5), tune.loguniform(1e-5, 1e-1),
             tune.randint(1, 9), tune.choice(["a", "b", "c"])]
    out = [sample(s, r) for s in specs for _ in range(3)]
    out.append(sample(tune.sample_from(lambda spec: spec.config["a"] * 2),
                      r, {"a": 21}))
    return out


def random_searcher(pkg):
    tune = _tune(pkg)
    s = tune.RandomSearcher({"x": tune.uniform(0, 1),
                             "lr": tune.loguniform(1e-5, 1e-1)},
                            num_samples=5, seed=0)
    return [s.suggest(f"t{i}") for i in range(6)] + [s.is_finished()]


def concurrency_limiter(pkg):
    tune = _tune(pkg)
    lim = tune.ConcurrencyLimiter(
        tune.RandomSearcher({"x": tune.uniform(0, 1)}, num_samples=4,
                            seed=0), max_concurrent=2)
    out = [lim.suggest("a"), lim.suggest("b"), lim.suggest("c"),
           lim.is_finished()]
    for done, nxt in (("a", "c"), ("b", "d"), ("c", "e")):
        lim.on_trial_complete(done, {"loss": 1.0})
        out.append(lim.suggest(nxt))
    return out + [lim.is_finished()]


def _quadratic_search(searcher, n: int, prefix: str) -> list:
    xs = []
    for i in range(n):
        cfg = searcher.suggest(f"{prefix}{i}")
        xs.append(cfg["x"])
        searcher.on_trial_complete(f"{prefix}{i}",
                                   {"loss": (cfg["x"] - 2.0) ** 2})
    return [xs, searcher.suggest(f"{prefix}{n}"), searcher.is_finished()]


def tpe(pkg):
    tune = _tune(pkg)
    return _quadratic_search(tune.TPESearcher(
        {"x": tune.uniform(-5, 5)}, metric="loss", mode="min",
        num_samples=40, n_startup=10, seed=3), 40, "t")


def bayesopt(pkg):
    tune = _tune(pkg)
    out = _quadratic_search(tune.BayesOptSearcher(
        {"x": tune.uniform(-5, 5)}, metric="loss", mode="min",
        num_samples=36, n_startup=8, seed=7), 36, "b")
    bo = tune.BayesOptSearcher(
        {"lr": tune.loguniform(1e-5, 1e-1), "layers": tune.randint(1, 9),
         "act": tune.choice(["relu", "gelu"])},
        num_samples=12, n_startup=4, seed=0)
    mixed = []
    for i in range(12):
        cfg = bo.suggest(f"m{i}")
        mixed.append(cfg)
        bo.on_trial_complete(
            f"m{i}", {"loss": abs(cfg["lr"] - 1e-3) * cfg["layers"]})
    return out + [mixed]


def bohb(pkg):
    tune = _tune(pkg)
    s = tune.BOHBSearcher({"x": tune.uniform(-5, 5)}, metric="loss",
                          mode="min", num_samples=40, n_startup=6, seed=5)
    xs = []
    for i in range(40):
        tid = f"h{i}"
        x = s.suggest(tid)["x"]
        xs.append(x)
        noisy = (x - 2.0) ** 2 + (10 if i % 2 else 0)
        s.on_trial_result(tid, {"loss": noisy, "training_iteration": 1})
        if i % 2 == 0:
            clean = {"loss": (x - 2.0) ** 2, "training_iteration": 3}
            s.on_trial_result(tid, clean)
            s.on_trial_complete(tid, clean)
        else:
            s.on_trial_complete(tid, {"loss": noisy,
                                      "training_iteration": 1})
    return [xs, sorted(s._budget_obs), len(s._budget_obs.get(3, []))]


def _interleaved(n_trials: int, steps: int, value) -> list:
    """(trial, step, metric) in a fixed interleaving: trial i reports its
    step s after trial i-1's step s + (i % 2)."""
    rows = [(f"t{i}", s, value(i, s)) for i in range(n_trials)
            for s in range(1, steps + 1)]
    return sorted(rows, key=lambda r: (r[1] + int(r[0][1:]) % 2, r[0]))


def _decisions(sched, rows, metric: str = "loss") -> list:
    out = []
    stopped = set()
    for tid, step, v in rows:
        if tid in stopped:
            continue
        d = sched.on_result(tid, {metric: v, "training_iteration": step})
        out.append((tid, step, d))
        if d != "CONTINUE":
            stopped.add(tid)
            sched.on_trial_complete(tid)
    return out


def asha(pkg):
    tune = _tune(pkg)
    sched = tune.ASHAScheduler(metric="loss", mode="min", max_t=20,
                               grace_period=2, reduction_factor=2)
    return _decisions(sched, _interleaved(
        6, 20, lambda i, s: (1.0 + 7 * (i % 3)) / s + 0.01 * i))


def hyperband(pkg):
    tune = _tune(pkg)
    hb = tune.HyperBandScheduler(metric="loss", mode="min", max_t=27,
                                 reduction_factor=3)
    for i in range(6):
        hb.on_trial_add(f"t{i}", {})
    brackets = [(b.grace_period, b._rungs) for b in hb._brackets]
    return [brackets, dict(hb._assignment), _decisions(hb, _interleaved(
        6, 27, lambda i, s: (1.0 + i) / s))]


def median_stopping(pkg):
    tune = _tune(pkg)
    rule = tune.MedianStoppingRule(metric="loss", mode="min",
                                   grace_period=2, min_samples_required=3)
    out = []
    for step in range(1, 5):
        for tid in ("a", "b", "c", "d"):
            out.append(rule.on_result(tid, {"loss": 1.0 / step,
                                            "training_iteration": step}))
    out += [rule.on_result("bad", {"loss": 10.0, "training_iteration": s})
            for s in range(1, 4)]
    return out


def pbt(pkg):
    tune = _tune(pkg)
    p = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.1, 0.5, 1.0],
                              "wd": tune.uniform(0.0, 0.1)},
        quantile_fraction=0.25, seed=0)
    out = []
    for i, tid in enumerate(("w", "x", "y", "z")):
        p.on_trial_add(tid, {"lr": 0.1 if i < 2 else 1.0, "wd": 0.05})
        p.on_checkpoint(tid, f"/ckpt/{tid}")
    for step in range(2, 13, 2):
        for i, tid in enumerate(("y", "z", "x", "w")):
            d = p.on_result(tid, {"score": step * (i + 1) % 7,
                                  "training_iteration": step})
            out.append(d)
            if d == "EXPLOIT":
                out.append(p.exploit(tid))
    try:
        tune.PopulationBasedTraining(metric="m")
    except ValueError as e:
        out.append(str(e))
    return out + [p.exploit_count]


def pb2_gp(pkg):
    gp = _sub(pkg, "pb2")._TinyGP()
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (40, 2))
    y = -((X[:, 0] - 0.7) ** 2) + 0.1 * X[:, 1]
    gp.fit(X, (y - y.mean()) / (y.std() + 1e-9))
    mu, sigma = gp.predict(rng.uniform(0, 1, (101, 2)))
    return [mu, sigma]


def pb2_explore(pkg):
    tune = _tune(pkg)
    sch = tune.PB2(metric="score", mode="max",
                   hyperparam_bounds={"lr": [1e-4, 1e-1]},
                   hyperparam_mutations={"opt": ["sgd", "adam"]}, seed=0)
    for i, trial in enumerate(("a", "b", "c")):
        sch.on_trial_add(trial, {"lr": 0.01 * (i + 1), "opt": "sgd"})
        for t in range(1, 6):
            sch.on_result(trial, {"score": t * (i + 1) * 0.01,
                                  "training_iteration": t})
    explored = [sch._explore({"lr": 0.05, "opt": "sgd"}) for _ in range(10)]
    try:
        tune.PB2(metric="m")
    except ValueError as e:
        explored.append(str(e))
    return explored


def stoppers(pkg):
    tune = _tune(pkg)
    st = tune.TrialPlateauStopper(metric="m", std=0.01, num_results=3,
                                  grace_period=3)
    improving = [st("t", {"m": float(i)}) for i in range(6)]
    st2 = tune.TrialPlateauStopper(metric="m", std=0.01, num_results=3,
                                   grace_period=3)
    flat = [st2("t", {"m": 1.0}) for _ in range(4)]
    mx = tune.MaximumIterationStopper(3)
    return [improving, flat, [mx("t", {}) for _ in range(4)],
            mx.stop_all()]


def factories(pkg):
    tune = _tune(pkg)
    space = {"x": tune.uniform(0, 1)}
    model = {"metric": "loss", "mode": "min"}
    out = [type(tune.create_searcher(
        name, param_space=space, num_samples=4,
        **({} if name in ("random", "variant_generator") else model))
    ).__name__ for name in ("random", "tpe", "bayesopt", "bohb",
                            "variant_generator")]
    out += [type(tune.create_scheduler(
        name, **({} if name == "fifo" else model))).__name__
        for name in ("asha", "hyperband", "median_stopping_rule", "fifo")]
    for fn in (tune.create_searcher, tune.create_scheduler):
        try:
            fn("nope")
        except ValueError as e:
            out.append(str(e))
    return out


def optuna_ask_tell(pkg):
    tune = _tune(pkg)
    study = programs.MockStudy([{"lr": 0.1, "layers": 3, "act": "gelu"},
                                {"lr": 0.2, "layers": 5, "act": "relu"}])
    s = tune.OptunaSearch(
        {"lr": tune.uniform(0.01, 1.0), "layers": tune.randint(1, 8),
         "act": tune.choice(["gelu", "relu"]), "fixed": 42},
        metric="loss", mode="min", num_samples=2, study=study)
    out = [s.suggest("t0"), s.suggest("t1"), s.is_finished(),
           s.suggest("t2")]
    s.on_trial_complete("t0", {"loss": 0.5})
    s.on_trial_complete("t1", None, error=True)
    s.on_trial_complete("zzz", {"loss": 1.0})
    runs = programs.MockStudy()
    by_run = tune.OptunaSearch(
        lambda trial: {"x": trial.suggest_float("x", 0.0, 4.0)},
        metric="m", mode="max", num_samples=3, study=runs)
    try:
        tune.OptunaSearch({"x": tune.uniform(0, 1)})
    except ImportError as e:
        missing = "optuna" in str(e)
    return out + [study.tells, by_run.suggest("a"), missing]


CASES = {f.__name__: f for f in (
    basic_variant, samplers, random_searcher, concurrency_limiter, tpe,
    bayesopt, bohb, asha, hyperband, median_stopping, pbt, pb2_gp,
    pb2_explore, stoppers, factories, optuna_ask_tell)}


def _equal(a, b, tol: float) -> bool:
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and bool(np.allclose(a, b, rtol=tol,
                                                       atol=tol))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y, tol) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k], tol)
                                            for k in a)
    return a == b


@pytest.fixture(scope="module")
def outcomes() -> dict:
    return {name: {pkg: fn(pkg) for pkg in PACKAGES}
            for name, fn in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_same_decisions_on_both_packages(outcomes, case):
    jax_out, port_out = (outcomes[case][pkg] for pkg in PACKAGES)
    tol = 1e-12 if case == "pb2_gp" else 0.0
    assert _equal(jax_out, port_out, tol), (jax_out, port_out)


def _err(xs) -> float:
    return sum(abs(x - 2.0) for x in xs) / len(xs)


# What each case must show (the JAX package's unit tests' requirements).
REQUIRED = {
    "basic_variant": lambda o: (
        o[0] == 6 and None not in o[1] and o[2] is None
        and {c["lr"] for c in o[1]} == {0.1, 0.01}
        and all(0 <= c["x"] <= 1 for c in o[1])),
    "samplers": lambda o: (
        all(v in (0.0, 0.25, 0.5, 0.75, 1.0) for v in o[0:3])
        and all(isinstance(v, int) and v % 10 == 0 for v in o[3:6])
        and all(isinstance(v, int) and 1 <= v <= 1000 for v in o[6:9])
        and all(isinstance(v, float) for v in o[9:12]) and o[-1] == 42),
    "random_searcher": lambda o: (
        None not in o[:5] and o[5] is None and o[6]
        and all(1e-5 <= c["lr"] <= 1e-1 for c in o[:5])),
    "concurrency_limiter": lambda o: (
        o[0] is not None and o[1] is not None and o[2] is None
        and not o[3] and o[4] is not None and o[5] is not None
        and o[6] is None and o[7]),
    "tpe": lambda o: (o[1] is None and o[2]
                      and _err(o[0][-10:]) < _err(o[0][:10])),
    "bayesopt": lambda o: (
        o[1] is None and o[2] and _err(o[0][-8:]) < _err(o[0][:8])
        and all(1e-5 <= c["lr"] <= 1e-1 and 1 <= c["layers"] <= 8
                and c["act"] in ("relu", "gelu") for c in o[3])),
    "bohb": lambda o: (_err(o[0][-10:]) < _err(o[0][:10])
                       and 3 in o[1] and o[2] >= 6),
    "asha": lambda o: (
        any(t == "t2" and d == "STOP" and s < 20 for t, s, d in o)
        and ("t0", 20, "STOP") in o),
    "hyperband": lambda o: (len(o[0]) >= 2 and len({g for g, _ in o[0]}) >= 2
                            and o[1]["t0"] != o[1]["t1"]),
    "median_stopping": lambda o: (set(o[:16]) == {"CONTINUE"}
                                  and "STOP" in o[16:]),
    "pbt": lambda o: (o[-1] >= 1 and all(
        ckpt in ("/ckpt/w", "/ckpt/x", "/ckpt/y", "/ckpt/z")
        for x in o if isinstance(x, tuple) for ckpt in x[1:])
        and "hyperparam_mutations" in o[-2]),
    "pb2_gp": lambda o: (o[1] >= 0).all(),
    "pb2_explore": lambda o: (
        all(1e-4 <= c["lr"] <= 1e-1 and c["opt"] in ("sgd", "adam")
            for c in o[:10]) and "hyperparam_bounds" in o[10]),
    "stoppers": lambda o: (not any(o[0]) and o[1][-1] is True
                           and o[2] == [False, False, True, True]
                           and o[3] is False),
    "factories": lambda o: (
        o[:9] == ["RandomSearcher", "TPESearcher", "BayesOptSearcher",
                  "BOHBSearcher", "BasicVariantGenerator", "ASHAScheduler",
                  "HyperBandScheduler", "MedianStoppingRule",
                  "FIFOScheduler"]
        and "unknown searcher" in o[9] and "unknown scheduler" in o[10]),
    "optuna_ask_tell": lambda o: (
        o[0] == {"lr": 0.1, "layers": 3, "act": "gelu", "fixed": 42}
        and o[1]["act"] == "relu" and o[2] and o[3] is None
        and o[4] == [(0, 0.5, None), (1, None, "FAIL")]
        and o[5] == {"x": 2.0} and o[6]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_outcome_meets_the_reference_requirements(outcomes, case):
    assert REQUIRED[case](outcomes[case]["ray_tpu_torch"]), \
        outcomes[case]["ray_tpu_torch"]
