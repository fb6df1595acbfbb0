"""ray_tpu_torch.tune — hyperparameter search (Ray Tune analog), the
counterpart of ``ray_tpu.tune`` on the port's runtime.

Trials are actors scheduled by the core runtime. A trial holds the share
of a card its ``resources_per_trial`` asks for (``{"GPU": 0.5}``: two
trials on one card; ``{"GPU": 1}``: a card each), or, as a
``TorchTrainer``, its trainer's gang holds the cards.
"""

from ray_tpu_torch.tune.search import (
    grid_search, choice, uniform, loguniform, randint,
    BasicVariantGenerator, RandomSearcher, TPESearcher,
    BayesOptSearcher, BOHBSearcher,
    ConcurrencyLimiter, Searcher,
)
from ray_tpu_torch.tune.optuna import OptunaSearch
from ray_tpu_torch.tune.schedulers import (
    FIFOScheduler, ASHAScheduler, HyperBandScheduler,
    MedianStoppingRule, PopulationBasedTraining,
)
from ray_tpu_torch.tune.pb2 import PB2  # noqa: E402
from ray_tpu_torch.tune.compat import (  # noqa: E402
    MaximumIterationStopper, Stopper, TrialPlateauStopper,
    register_trainable, run, with_parameters, with_resources,
)
from ray_tpu_torch.tune.search import (  # noqa: E402
    lograndint, qlograndint, qloguniform, qrandint, qrandn,
    quniform, randn, sample_from,
)
from ray_tpu_torch.tune.tune import (
    Tuner, TuneConfig, Trial, ResultGrid, TrialResult,
)
from ray_tpu_torch.tune.classic import (  # noqa: E402
    Callback, CLIReporter, Experiment, ExperimentAnalysis,
    PlacementGroupFactory, ProgressReporter, ResumeConfig,
    Trainable, TuneError, create_scheduler, create_searcher,
    run_experiments,
)
from ray_tpu_torch.tune.registry import register_env  # noqa: E402

__all__ = [
    "grid_search", "choice", "uniform", "loguniform", "randint",
    "quniform", "qloguniform", "qrandint", "qlograndint", "qrandn",
    "lograndint", "randn", "sample_from",
    "run", "register_trainable", "with_parameters", "with_resources",
    "Stopper", "MaximumIterationStopper", "TrialPlateauStopper",
    "BasicVariantGenerator", "RandomSearcher", "TPESearcher",
    "BayesOptSearcher", "BOHBSearcher",
    "ConcurrencyLimiter", "Searcher", "OptunaSearch",
    "FIFOScheduler", "ASHAScheduler", "HyperBandScheduler",
    "MedianStoppingRule", "PopulationBasedTraining", "PB2",
    "Tuner", "TuneConfig", "Trial", "ResultGrid", "TrialResult",
    "Trainable", "Callback", "ProgressReporter", "CLIReporter",
    "ExperimentAnalysis", "Experiment", "run_experiments",
    "create_searcher", "create_scheduler", "PlacementGroupFactory",
    "TuneError", "ResumeConfig", "register_env",
]
